"""The port's CLI with observability on (``dmlp_tpu_torch.obs``): span
traces and metrics records that the reference's checker accepts, the
reference's span names and summary keys on the same input and path, the
contract channels byte-identical with every flag on, ``--profile``, the
crash flight recorder, and nothing installed when no flag is given."""

import glob
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from dmlp_tpu import cli as ref_cli  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu_torch import cli  # noqa: E402
from dmlp_tpu_torch.obs import counters as obs_counters  # noqa: E402
from dmlp_tpu_torch.obs import telemetry  # noqa: E402
from dmlp_tpu_torch.obs import trace as obs_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# path -> (datagen args, flags): the six paths of tests/test_torch_cli.py.
PATHS = {
    "sort": ((2500, 30, 6, -10.0, 10.0, 1, 12, 4), []),
    "topk": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), []),
    "extract": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), ["--pallas"]),
    "router": ((9000, 24, 6, 0.0, 50.0, 1, 900, 5), ["--pallas"]),
    "multipass": ((9000, 8, 4, 0.0, 50.0, 600, 700, 5), ["--pallas"]),
    "seg": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), ["--select", "seg",
                                                 "--pallas"]),
}


def _run(main, argv, text):
    out, err = io.StringIO(), io.StringIO()
    assert main(argv, stdin=io.StringIO(text), stdout=out, stderr=err) == 0
    return out.getvalue(), err.getvalue()


def _obs_flags(tmp_path, tag):
    return ["--trace", str(tmp_path / f"{tag}.trace.json"),
            "--metrics", str(tmp_path / f"{tag}.metrics.jsonl"),
            "--counters", "--telemetry", str(tmp_path / f"{tag}.om"),
            "--telemetry-port", "0"]


def _span_names(path):
    with open(path) as f:
        return {e["name"] for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"}


def _summary(path):
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])


@pytest.mark.parametrize("path", list(PATHS))
def test_every_obs_flag_keeps_the_contract_channels(path, tmp_path):
    """stdout with every obs flag on equals the flag-free run's, the
    reference's and golden's; stderr starts with the unchanged ``Time
    taken`` line and the ``counters:`` / ``roofline:`` lines follow it."""
    gen, flags = PATHS[path]
    text = generate_input_text(*gen, seed=7)
    base = ["--device", "cpu", *flags]
    plain, _ = _run(cli.main, base, text)
    got, err = _run(cli.main, base + _obs_flags(tmp_path, path), text)
    want, _ = _run(ref_cli.main, flags, text)
    golden, _ = _run(cli.main, ["--engine", "golden"], text)
    assert got == plain == want == golden
    lines = err.splitlines()
    assert re.fullmatch(r"Time taken: \d+ ms", lines[0])
    assert lines[1].startswith("counters: flops=")
    assert lines[2].startswith("roofline: ")
    assert len(lines) == 3


# (datagen args, flags) at row counts where both packages plan the same
# chunks: 25,600 rows in two chunks of 12,800 on the extraction path (the
# port's 256-row granule and the reference's 12,800-row one agree there),
# and the topk fold's single chunk.
SPAN_CASES = {
    "topk": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), ["--select", "topk"]),
    "extract": ((25600, 24, 6, 0.0, 50.0, 1, 16, 5),
                ["--pallas", "--select", "extract", "--data-block",
                 "12800"]),
}


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_trace_and_metrics_pass_the_checker_and_cover_the_reference(
        case, tmp_path):
    """The port's trace and metrics pass ``tools/check_trace.py``; its
    span names include every span name the reference emits on the same
    input and path; the summary record's keys are the reference's; the
    counters' extraction term is measured on the extraction path."""
    gen, flags = SPAN_CASES[case]
    text = generate_input_text(*gen, seed=11)
    pt, pm = tmp_path / "port.json", tmp_path / "port.jsonl"
    rt, rm = tmp_path / "ref.json", tmp_path / "ref.jsonl"
    got, _ = _run(cli.main, ["--device", "cpu", *flags, "--trace", str(pt),
                             "--metrics", str(pm)], text)
    want, _ = _run(ref_cli.main, [*flags, "--trace", str(rt),
                                  "--metrics", str(rm)], text)
    assert got == want
    p = subprocess.run([sys.executable, "tools/check_trace.py", str(pt),
                        str(pm)], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    ref_names, port_names = _span_names(rt), _span_names(pt)
    assert ref_names <= port_names, ref_names - port_names
    if case == "extract":
        assert "single.prune_score" in ref_names
    port_sum, ref_sum = _summary(pm), _summary(rm)
    assert set(port_sum) == set(ref_sum) - {"hlo"}
    c = port_sum["counters"]
    assert c["dispatches_recorded"] > 0
    if case == "extract":
        assert c["extraction_term"] == "measured"
        assert port_sum["extract_impl"] == ref_sum["extract_impl"]
        assert port_sum["prune"] == ref_sum["prune"]


def test_no_flag_installs_nothing():
    """Off means off: after a full CLI solve with no obs flag there is no
    tracer, probe or telemetry session, and none survives a flagged run."""
    gen, flags = PATHS["extract"]
    text = generate_input_text(*gen, seed=3)
    _run(cli.main, ["--device", "cpu", *flags], text)
    assert obs_trace.active() is None
    assert obs_counters.active() is None
    assert telemetry.session() is None
    assert not obs_trace.sinks_active()


def test_flags_leave_nothing_installed(tmp_path):
    gen, flags = PATHS["extract"]
    text = generate_input_text(*gen, seed=3)
    _run(cli.main, ["--device", "cpu", *flags,
                    *_obs_flags(tmp_path, "x")], text)
    assert obs_trace.active() is None
    assert obs_counters.active() is None
    assert telemetry.session() is None
    assert not obs_trace.sinks_active()


def test_profile_writes_a_chrome_trace(tmp_path):
    """``--profile DIR``: a torch.profiler capture of the timed solve with
    the trace's span names mirrored into it (``record_function``), and a
    ``profile`` block in the metrics summary (on the CPU the explicit
    marker: there is no device activity to measure an idle share of)."""
    gen, flags = PATHS["extract"]
    text = generate_input_text(*gen, seed=5)
    prof = tmp_path / "prof"
    got, _ = _run(cli.main, ["--device", "cpu", *flags, "--profile",
                             str(prof), "--trace", str(tmp_path / "t.json"),
                             "--metrics", str(tmp_path / "m.jsonl")], text)
    golden, _ = _run(cli.main, ["--engine", "golden"], text)
    assert got == golden
    with open(prof / "profile.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "single.enqueue_extract" in names
    block = _summary(tmp_path / "m.jsonl")["profile"]
    assert block["device_idle_unavailable"] and block["wall_ms"] > 0
    assert block["trace"] == str(prof / "profile.json")


def test_busy_time_is_the_union_of_the_device_intervals():
    from dmlp_tpu_torch.obs.counters import busy_ms
    assert busy_ms([(30, 40), (0, 10), (5, 20)]) == 0.03
    assert busy_ms([(0, 5), (5, 9)]) == 0.009
    assert busy_ms([]) == 0.0


def test_a_fatal_fault_leaves_a_flight_artifact(tmp_path):
    """A transient fault past the retries at the fetch fails the solve:
    the telemetry session dumps ``FLIGHT_*.json`` beside the telemetry
    file, with the reference's keys, the fault among its events."""
    gen, flags = PATHS["extract"]
    text = generate_input_text(*gen, seed=5)
    sched = tmp_path / "faults.json"
    sched.write_text(json.dumps({"schema": 1, "seed": 0, "faults": [
        {"site": "single.fetch", "kind": "transient", "times": 10}]}))
    with pytest.raises(Exception, match="injected transient"):
        cli.main(["--device", "cpu", *flags, "--faults", str(sched),
                  "--telemetry", str(tmp_path / "t.om")],
                 stdin=io.StringIO(text), stdout=io.StringIO(),
                 stderr=io.StringIO())
    assert telemetry.session() is None
    dumps = sorted(glob.glob(str(tmp_path / "FLIGHT_*.json")))
    reasons = {os.path.basename(p).split("_pid")[0] for p in dumps}
    assert reasons == {"FLIGHT_fatal_fault", "FLIGHT_crash"}
    with open(dumps[0]) as f:
        doc = json.load(f)
    assert set(doc) == {"flight_schema", "reason", "unix_time", "pid",
                        "events", "metrics", "resilience"}
    assert any(e["kind"] == "fault" and e["name"] == "single.fetch"
               for e in doc["events"])
    assert doc["resilience"]["retries"] == 2
