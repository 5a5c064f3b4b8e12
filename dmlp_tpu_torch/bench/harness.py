"""Benchmark orchestration: generate -> oracle (cached) -> engine -> compare.

Port of ``dmlp_tpu/bench/harness.py``, the run_bench.sh of the port. Per
config (configs.py):

1. regenerate the canonical input if missing (seeded, byte-stable —
   inputs/inputN.in, byte for byte the reference harness's);
2. run the oracle once and cache outputs/test_N.{out,err}
   (run_bench.sh:79-84's cache), using the port's float64 oracle
   (``golden.fast``) in place of the unrunnable x86 oracle binaries;
3. run the engine via the real CLI entry (``python -m dmlp_tpu_torch``,
   the same stdin/stdout/stderr contract as ``mpirun ./engine < input``)
   on the device the caller names (``--device cuda`` by default, passed
   to every subprocess), writing outputs/tmp.{out,err};
4. diff the checksum channel (correctness) and compare the `Time taken`
   lines (performance) in run_bench.sh:29-72's report format.

Every RunRecord this harness writes names its device: the card's name
(``obs.run.current_device``) or "cpu", never unset, so the ledger never
compares a port round with a TPU-era round of the same series
(``device_mismatch``).
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time
from typing import Optional, TextIO

from dmlp_tpu_torch.bench.configs import BENCH_CONFIGS, BenchConfig

TOOL = "dmlp_tpu_torch.bench"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _extract_ms(err_text: str) -> Optional[int]:
    m = re.search(r"Time taken:\s*(\d+)", err_text)
    return int(m.group(1)) if m else None


def compare_times(bench_err: str, engine_err: str, out: TextIO) -> Optional[float]:
    """The compare_times report (run_bench.sh:29-72); returns percent diff
    (positive = engine slower), or None if a timing line is missing."""
    bench_ms = _extract_ms(bench_err)
    engine_ms = _extract_ms(engine_err)
    if bench_ms is None or engine_ms is None:
        out.write("Error: Could not extract timing information from .err files.\n")
        return None
    out.write("\n=== Performance Comparison ===\n")
    out.write(f"Benchmark time: {bench_ms} ms\n")
    out.write(f"Engine time:    {engine_ms} ms\n")
    diff = engine_ms - bench_ms
    if bench_ms == 0:
        # Oracle rounded to 0 ms — a percentage would be meaningless (and
        # claiming 0% would falsely declare parity).
        out.write(f"Difference:     +{diff} ms (oracle < 1 ms; no %)\n")
        out.write("==============================\n\n")
        return None
    percent = (engine_ms - bench_ms) / bench_ms * 100.0
    if percent > 0:
        out.write(f"Difference:     +{abs(diff)} ms ({percent:.2f}% slower)\n")
    elif percent < 0:
        out.write(f"Difference:     -{abs(diff)} ms ({abs(percent):.2f}% "
                  "faster) \U0001f389\U0001f389\U0001f389\n")
    else:
        out.write("Difference:     0 ms (No difference)\n")
    out.write("==============================\n\n")
    return percent


def ensure_input(cfg: BenchConfig, inputs_dir: str) -> str:
    """Generate the config's seeded input if not cached; returns the path."""
    from dmlp_tpu_torch.io.datagen import generate_input_text

    os.makedirs(inputs_dir, exist_ok=True)
    path = os.path.join(inputs_dir, cfg.input_name)
    if not os.path.exists(path):
        text = generate_input_text(cfg.num_data, cfg.num_queries,
                                   cfg.num_attrs, cfg.min_attr, cfg.max_attr,
                                   cfg.min_k, cfg.max_k, cfg.num_labels,
                                   seed=cfg.seed)
        with open(path, "w") as f:
            f.write(text)
    return path


def ensure_oracle(cfg: BenchConfig, input_path: str, outputs_dir: str,
                  out: TextIO, force: bool = False) -> tuple[str, str]:
    """Run the golden oracle (cached) for a config; returns (.out, .err) paths."""
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.grammar import parse_input
    from dmlp_tpu_torch.io.report import format_results
    from dmlp_tpu_torch.utils.timing import format_time_taken

    os.makedirs(outputs_dir, exist_ok=True)
    out_path = os.path.join(outputs_dir, f"test_{cfg.config_id}.out")
    err_path = os.path.join(outputs_dir, f"test_{cfg.config_id}.err")
    if os.path.exists(err_path) and os.path.exists(out_path) and not force:
        out.write("Output found in cache. Skipping...\n")
        return out_path, err_path
    with open(input_path, "rb") as f:  # binary -> native parser dispatch
        inp = parse_input(f)
    t0 = time.perf_counter()
    stats: dict = {}
    results = knn_golden_fast(inp, stats=stats)
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    if stats.get("fallbacks"):
        out.write(f"oracle: {stats['fallbacks']} queries took the strict "
                  "fallback path\n")
    with open(out_path, "w") as f:
        f.write(format_results(results))
    with open(err_path, "w") as f:
        f.write(format_time_taken(elapsed_ms))
    return out_path, err_path


class EngineTimeout(RuntimeError):
    """The engine subprocess exceeded the harness timeout and was killed."""


def _engine_flags(cfg: BenchConfig, effective_mode: str,
                  device: str = "cuda") -> list:
    """Engine path flags shared by the single- and multi-process runners —
    one place to wire new BenchConfig knobs (a knob that never reaches
    the argv benches the default path silently)."""
    argv = []
    if cfg.mesh_shape is not None and effective_mode != "single":
        argv += ["--mesh", f"{cfg.mesh_shape[0]},{cfg.mesh_shape[1]}"]
    if cfg.backend is not None and (effective_mode != "single"
                                    or cfg.procs > 1):
        argv += ["--backend", cfg.backend]
    if cfg.use_pallas:
        argv.append("--pallas")
    if cfg.select != "auto":
        argv += ["--select", cfg.select]
    argv += ["--device", device]
    return argv


def _engine_env(env: Optional[dict]) -> dict:
    """Subprocess environment: the caller's (or this process's), with the
    repository on PYTHONPATH so ``python -m dmlp_tpu_torch`` resolves from
    any working directory."""
    e = dict(env if env is not None else os.environ)
    parts = [p for p in e.get("PYTHONPATH", "").split(os.pathsep) if p]
    if REPO not in parts:
        parts.insert(0, REPO)
    e["PYTHONPATH"] = os.pathsep.join(parts)
    return e


def run_engine(cfg: BenchConfig, input_path: str, outputs_dir: str,
               mode: Optional[str] = None, fast: bool = False,
               warmup: bool = True, timeout_s: float = 300.0,
               env: Optional[dict] = None,
               obs_flags: Optional[list] = None,
               device: str = "cuda") -> tuple[str, str]:
    """Run the engine CLI as a subprocess over a real pipe, under a kill
    timeout; returns (tmp.out, tmp.err) paths.

    A subprocess + timeout mirrors the reference's hang protection
    (``mpirun --timeout 300``, run_bench.sh:82) — one wedged run must fail
    its config, not block the whole suite. Defaults to exact (f64-parity)
    mode — the harness exists to prove checksum parity, like the
    reference's oracle diff; ``fast=True`` drops the host rescore for
    pure-device timing at the cost of f32 ordering. ``cfg.mesh_shape``
    (run_bench.sh's task-count analog) is passed through as ``--mesh``.
    ``warmup`` solves once untimed first, so the first launches and
    allocations stay out of ``Time taken``. ``obs_flags`` (e.g.
    ``["--trace", path]``) ride through to the engine CLI — the
    per-config observability capture.
    """
    import subprocess

    argv = [sys.executable, "-m", "dmlp_tpu_torch", "--mode",
            mode or cfg.mode]
    argv += _engine_flags(cfg, mode or cfg.mode, device)
    if fast:
        argv.append("--fast")
    if warmup:
        argv.append("--warmup")
    if obs_flags:
        argv += list(obs_flags)
    with open(input_path, "rb") as stdin:
        proc = subprocess.Popen(argv, stdin=stdin, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                env=_engine_env(env))
        try:
            out_b, err_b = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise EngineTimeout(
                f"engine exceeded {timeout_s:.0f}s timeout (killed), "
                f"cf. mpirun --timeout at run_bench.sh:82")
    if proc.returncode != 0:
        raise RuntimeError(f"engine CLI exited {proc.returncode}: "
                           f"{err_b.decode()[-2000:]}")
    tmp_out = os.path.join(outputs_dir, "tmp.out")
    tmp_err = os.path.join(outputs_dir, "tmp.err")
    with open(tmp_out, "wb") as f:
        f.write(out_b)
    with open(tmp_err, "wb") as f:
        f.write(err_b)
    return tmp_out, tmp_err


def run_engine_multiproc(cfg: BenchConfig, input_path: str, outputs_dir: str,
                         timeout_s: float = 300.0,
                         env: Optional[dict] = None,
                         device: str = "cuda") -> tuple[str, str]:
    """Run the engine as a real ``cfg.procs``-process cluster (``python -m
    dmlp_tpu_torch.distributed``, one process a rank, the group on
    ``cfg.backend``) under the kill timeout — the harness-owned form of
    the reference's 2-node mpirun (run_bench.sh:82-84). Process 0's stdout
    is the canonical results channel (grader-diffed); all processes must
    exit 0 within the timeout or the config fails."""
    import concurrent.futures as cf
    import socket
    import subprocess

    def launch_once():
        # NOTE: probe-then-rebind has an inherent TOCTOU window (another
        # process can grab the ephemeral port before the coordinator binds
        # it); kept because the process group's TCP store offers no
        # bind-then-hand-off API here. The caller retries once on a bind
        # failure.
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]

        argv0 = [sys.executable, "-m", "dmlp_tpu_torch.distributed",
                 "--input", input_path,
                 "--coordinator", f"localhost:{port}",
                 "--processes", str(cfg.procs), "--warmup"]
        argv0 += _engine_flags(cfg, cfg.mode, device)
        procs = [subprocess.Popen(argv0 + ["--process-id", str(pid)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, env=run_env)
                 for pid in range(cfg.procs)]
        # Drain every process concurrently under ONE cluster deadline:
        # sequential communicate(timeout) would leave later processes' pipes
        # undrained (a stalled collective once ~64 KiB of stderr backs up)
        # and would multiply the worst-case wall clock by N.
        with cf.ThreadPoolExecutor(len(procs)) as ex:
            futs = [ex.submit(p.communicate) for p in procs]
            done, pending = cf.wait(futs, timeout=timeout_s)
            if pending:
                for proc in procs:
                    proc.kill()
                outs = [f.result() for f in futs]  # drains after the kills
                raise EngineTimeout(
                    f"{cfg.procs}-process cluster exceeded {timeout_s:.0f}s "
                    f"timeout (killed), cf. mpirun --timeout at "
                    f"run_bench.sh:82")
            outs = [f.result() for f in futs]
        for pid, proc in enumerate(procs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"process {pid} exited {proc.returncode}: "
                    f"{outs[pid][1].decode()[-2000:]}")
        return outs

    run_env = _engine_env(env)
    try:
        outs = launch_once()
    except RuntimeError as e:
        # One retry with a fresh port when the TOCTOU race above landed
        # (the coordinator loses its probed port to another process).
        if not isinstance(e, EngineTimeout) \
                and "ddress already in use" in str(e):
            outs = launch_once()
        else:
            raise
    tmp_out = os.path.join(outputs_dir, "tmp.out")
    tmp_err = os.path.join(outputs_dir, "tmp.err")
    with open(tmp_out, "wb") as f:
        f.write(outs[0][0])                      # proc-0 canonical stdout
    with open(tmp_err, "wb") as f:
        f.write(outs[0][1])
    return tmp_out, tmp_err


def _counters_dispatches(err_text: str) -> Optional[int]:
    """The recorded launches of the ``--counters`` stderr summary."""
    m = re.search(r"^counters: .*dispatches=(\d+)", err_text, re.M)
    return int(m.group(1)) if m else None


def run_config(config_id: int, base_dir: str = ".",
               mode: Optional[str] = None, fast: bool = False,
               force_oracle: bool = False, out: Optional[TextIO] = None,
               timeout_s: float = 300.0, env: Optional[dict] = None,
               reps: int = 1, trace_dir: Optional[str] = None,
               counters: bool = False,
               record_path: Optional[str] = None,
               profile_dir: Optional[str] = None,
               obs_overhead: bool = False,
               fused_ab: bool = False,
               prune_ab: bool = False,
               precision_ab: bool = False,
               auto_ab: bool = False,
               telemetry_dir: Optional[str] = None,
               device: str = "cuda") -> dict:
    """Full benchmark flow for one config; returns a result summary dict.

    ``reps`` > 1 runs the engine subprocess that many times and reports
    the MEDIAN engine time (all runs' times recorded as engine_ms_reps;
    checksums verified on every run, and a run whose output mismatches
    drops the timings). The reference protocol is single-shot (one mpirun
    each, run_bench.sh:82-84); on the card the host sets ``Time taken``
    (parsing is outside it, but staging, the host prune scoring and the
    float64 finalize are inside), and host times move from run to run, so
    one run measures the host's state as much as the engine. Deviation
    documented here and visible in the artifact.

    Observability (dmlp_tpu_torch.obs): ``trace_dir`` captures a
    per-config Perfetto trace + metrics JSONL from the engine subprocess
    (trace_configN.json / metrics_configN.jsonl; the LAST rep's trace
    wins, every rep's metrics append); ``counters`` adds the engine's
    stderr counters summary (its recorded launches become
    ``counters_dispatches``); ``record_path`` appends one versioned
    RunRecord per config. Single-process configs only (a multi-process
    cluster would collide on the artifact files).

    ``profile_dir`` requests a per-config ``torch.profiler`` capture of
    the timed solve (the engine CLI's ``--profile``) into
    ``profile_dir/profile_configN/``, linked from that config's RunRecord
    artifacts (on the CPU it holds the host's activity only). A
    multi-process config, a failed run or an engine that wrote nothing
    records the explicit ``profile_unavailable`` marker instead — never a
    silently absent artifact.

    ``obs_overhead`` self-measures the observability layer's cost
    (interleaved tracing+counters off/on pairs, ``obs_overhead_pct``).
    ``fused_ab``, ``prune_ab``, ``precision_ab`` and ``auto_ab`` are the
    A/B arms (``DMLP_TPU_FUSED``, ``DMLP_TPU_PRUNE``,
    ``DMLP_TPU_PRECISION``, ``--mode auto|sharded|ring``), each holding
    its arms' stdout byte-equal and recording raw per-arm samples, each
    an explicit ``*_unavailable`` marker on failure.
    """
    out = out or sys.stdout
    cfg = BENCH_CONFIGS[config_id]
    if cfg.timeout_s is not None:
        timeout_s = cfg.timeout_s   # per-config override (configs.py)
    inputs_dir = os.path.join(base_dir, "inputs")
    outputs_dir = os.path.join(base_dir, "outputs")

    obs_flags: list = []
    if counters:
        obs_flags.append("--counters")
    if telemetry_dir:
        # Per-config live-telemetry capture (obs.telemetry): the engine
        # subprocess rewrites an OpenMetrics snapshot while it runs;
        # the final file is linked from the config's RunRecord
        # artifacts like the trace/metrics pair.
        os.makedirs(telemetry_dir, exist_ok=True)
        obs_flags += ["--telemetry",
                      os.path.join(telemetry_dir,
                                   f"telemetry_config{config_id}.prom")]
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        obs_flags += ["--trace",
                      os.path.join(trace_dir, f"trace_config{config_id}.json"),
                      "--metrics",
                      os.path.join(trace_dir,
                                   f"metrics_config{config_id}.jsonl")]
    profile: Optional[tuple] = None   # ("path", p) | ("unavailable", why)
    if profile_dir:
        pdir = os.path.join(profile_dir, f"profile_config{config_id}")
        os.makedirs(pdir, exist_ok=True)
        obs_flags += ["--profile", pdir]
        profile = ("path", pdir)
    if obs_flags and cfg.procs > 1:
        out.write(f"Config {config_id}: note — observability capture "
                  "applies to single-process configs only; skipping\n")
        obs_flags = []
        if profile is not None and profile[0] == "path":
            try:
                os.rmdir(profile[1])
            except OSError:
                pass
            profile = ("unavailable", "multi-process config")

    input_path = ensure_input(cfg, inputs_dir)
    oracle_out, oracle_err = ensure_oracle(cfg, input_path, outputs_dir, out,
                                           force=force_oracle)
    with open(oracle_out) as f:
        want = f.read()
    if cfg.procs > 1 and (mode or fast):
        out.write(f"Config {config_id}: note — --mode/--fast do not apply "
                  "to multi-process configs (the cluster runs the full "
                  "exact contract pipeline)\n")
    n_reps = max(reps, 1)
    # Checksums are verified on every rep except in single-process --fast
    # mode, where f64-oracle diffs are documented as expected output.
    check_reps = not (fast and cfg.procs == 1)
    rep_ms: list = []
    got = ee = None
    for _rep in range(n_reps):
        try:
            if cfg.procs > 1:
                engine_out, engine_err = run_engine_multiproc(
                    cfg, input_path, outputs_dir, timeout_s=timeout_s,
                    env=env, device=device)
            else:
                engine_out, engine_err = run_engine(
                    cfg, input_path, outputs_dir, mode=mode, fast=fast,
                    timeout_s=timeout_s, env=env, obs_flags=obs_flags,
                    device=device)
        except (EngineTimeout, RuntimeError) as e:
            if got is not None:
                # A later rep failed: keep the earlier good reps instead
                # of failing a config that already produced a verified
                # result (the reason reps exist).
                out.write(f"Config {config_id}: rep {_rep + 1}/{n_reps} "
                          f"failed ({e}); keeping {len(rep_ms)} good "
                          "rep(s)\n")
                break
            kind = "TIMEOUT" if isinstance(e, EngineTimeout) else "ERROR"
            out.write(f"Config {config_id}: {kind} ({e})\n")
            res = {"config": config_id, "checksums_match": False,
                   "oracle_ms": None, "engine_ms": None,
                   "percent_vs_oracle": None}
            if kind == "TIMEOUT":
                # Explicit marker: markers record an honest non-result
                # and never gate — a hung config must not fail the whole
                # bench run, only document itself.
                res["timeout"] = True          # legacy spelling
                res["timed_out"] = True        # the marker consumers key on
            else:
                res["error"] = str(e)
            if profile is not None and profile[0] == "path":
                # A killed/errored engine wrote no capture: record the
                # explicit marker (never a silently absent artifact) and
                # drop the pre-created empty capture dir.
                try:
                    os.rmdir(profile[1])
                except OSError:
                    pass
                profile = ("unavailable",
                           f"engine run failed ({kind.lower()})")
            if record_path:
                _append_run_record(record_path, cfg, res, trace_dir,
                                   profile=profile, device=device)
            return res
        with open(engine_out) as f:
            got_r = f.read()
        with open(engine_err) as f:
            ee_r = f.read()
        if check_reps and got_r != want:
            # A mismatching run's timing must not enter the median — the
            # artifact would otherwise carry a number derived from wrong
            # output with only checksums_match hinting at it.
            got, ee = got_r, ee_r
            rep_ms = []
            break
        got, ee = got_r, ee_r
        ms = _extract_ms(ee_r)
        if ms is not None:
            rep_ms.append(ms)

    checksums_match = want == got
    status = "PASS" if checksums_match else "FAIL"
    out.write(f"Config {config_id}: checksums {status} "
              f"({cfg.num_queries} queries)\n")

    with open(oracle_err) as f:
        oe = f.read()
    percent = compare_times(oe, ee, out)  # human report: last run
    oracle_ms = _extract_ms(oe)
    res = {"config": config_id, "checksums_match": checksums_match,
           "oracle_ms": oracle_ms, "engine_ms": _extract_ms(ee),
           "percent_vs_oracle": percent}
    if len(rep_ms) > 1:
        res["engine_ms"] = round(statistics.median(rep_ms))
        res["engine_ms_reps"] = rep_ms
        if oracle_ms:
            res["percent_vs_oracle"] = (
                (res["engine_ms"] - oracle_ms) / oracle_ms * 100.0)
    if counters:
        disp = _counters_dispatches(ee)
        if disp is not None:
            res["counters_dispatches"] = disp
    # MEASURED reference-binary baseline, when a capture exists for this
    # config (tools/capture_oracle.sh ran bench_1..4 in a container via
    # isolated-singleton Open MPI; configs 1-4 map 1:1 onto the captured
    # workloads; config 5's input has no captured binary counterpart).
    # (checksums_match gate: a wrong-output run's timing must not carry a
    # reference-binary multiple either.)
    if config_id in (1, 2, 3, 4) and res["engine_ms"] \
            and res["checksums_match"]:
        res.update(reference_binary_fields(
            os.path.join(base_dir, "oracle_capture", "ORACLE_GOLDEN.json"),
            config_id, res["engine_ms"]))
    if profile is not None and profile[0] == "path" \
            and not os.listdir(profile[1]):
        # The engine accepted --profile but wrote nothing: an explicit
        # marker, not a RunRecord pointing at an empty directory.
        profile = ("unavailable", "engine wrote no capture")
    ab = dict(input_path=input_path, outputs_dir=outputs_dir, out=out,
              fast=fast, timeout_s=timeout_s, env=env, pairs=n_reps,
              device=device)
    want_ab = want if check_reps else None
    if obs_overhead:
        res.update(_measure_obs_overhead(cfg, mode=mode, **ab))
    if fused_ab:
        res.update(_measure_fused_ab(cfg, mode=mode, oracle_want=want_ab,
                                     **ab))
    for on, kind, fn in ((prune_ab, "prune", _measure_prune_ab),
                         (precision_ab, "precision", _measure_precision_ab),
                         (auto_ab, "auto", _measure_auto_ab)):
        if not on:
            continue
        kw = {} if kind == "auto" else {"mode": mode}
        arm_res = fn(cfg, oracle_want=want_ab, **kw, **ab)
        res.update(arm_res)
        if record_path:
            # A dedicated kind="prune" / "precision" / "auto" RunRecord so
            # the A/B lands in the ledger's ``<kind>/configN/...`` family
            # (gated by the perf gate) alongside the plain bench record.
            import dataclasses as _dc

            from dmlp_tpu_torch.obs.run import (RunRecord, current_device,
                                                round_from_name)
            RunRecord(kind=kind, tool=TOOL,
                      config=_dc.asdict(cfg), metrics=dict(arm_res),
                      device=current_device(device),
                      round=round_from_name(record_path)
                      ).append_jsonl(record_path)
    if record_path:
        _append_run_record(record_path, cfg, res, trace_dir,
                           profile=profile, device=device,
                           telemetry_dir=telemetry_dir)
    return res


def _measure_obs_overhead(cfg: BenchConfig, input_path: str,
                          outputs_dir: str, out: TextIO,
                          mode: Optional[str], fast: bool,
                          timeout_s: float, env: Optional[dict],
                          pairs: int, device: str = "cuda") -> dict:
    """Interleaved obs-on/obs-off engine timings -> the
    ``obs_overhead_pct`` fields (see run_config docstring). "On" means
    the full opt-in capture stack: span tracing + metrics JSONL +
    cost counters, exactly what ``--trace/--metrics/--counters``
    enable. Never raises: any failed run yields the explicit
    ``obs_overhead_unavailable`` marker instead."""
    if cfg.procs > 1:
        return {"obs_overhead_unavailable": "multi-process config "
                "(observability capture is single-process only)"}
    on_flags = ["--trace",
                os.path.join(outputs_dir,
                             f"obs_overhead_trace_c{cfg.config_id}.json"),
                "--metrics",
                os.path.join(outputs_dir,
                             f"obs_overhead_metrics_c{cfg.config_id}.jsonl"),
                "--counters"]
    times: dict = {"off": [], "on": []}
    try:
        for rep in range(max(pairs, 1)):
            order = ("off", "on") if rep % 2 == 0 else ("on", "off")
            for arm in order:
                _, err_path = run_engine(
                    cfg, input_path, outputs_dir, mode=mode, fast=fast,
                    timeout_s=timeout_s, env=env,
                    obs_flags=on_flags if arm == "on" else None,
                    device=device)
                with open(err_path) as f:
                    ms = _extract_ms(f.read())
                if ms is None:
                    return {"obs_overhead_unavailable":
                            f"no timing line in the {arm}-arm run"}
                times[arm].append(ms)
    except (EngineTimeout, RuntimeError) as e:
        return {"obs_overhead_unavailable":
                f"engine run failed during the A/B: {e}"}
    med_off = statistics.median(times["off"])
    med_on = statistics.median(times["on"])
    if med_off <= 0:
        return {"obs_overhead_unavailable":
                "off-arm median rounded to 0 ms (a percentage would "
                "be meaningless)", "engine_ms_obs_off": times["off"],
                "engine_ms_obs_on": times["on"]}
    pct = (med_on - med_off) / med_off * 100.0
    out.write(f"Config {cfg.config_id}: obs overhead "
              f"{pct:+.1f}% (median {med_off} -> {med_on} ms over "
              f"{len(times['off'])} interleaved pair(s))\n")
    return {"obs_overhead_pct": round(pct, 2),
            "engine_ms_obs_off": times["off"],
            "engine_ms_obs_on": times["on"]}


def _env_arms(cfg: BenchConfig, input_path: str, outputs_dir: str,
              mode: Optional[str], fast: bool, timeout_s: float,
              env: Optional[dict], pairs: int, device: str, var: str,
              arm_env: dict, order0: tuple, tag: str):
    """Run the interleaved pairs of an environment-variable A/B: each arm
    with ``var`` set to its value and ``--metrics`` into its own file
    (order alternating per pair). Returns (times, outputs, summaries) per
    arm, the summaries the metrics channel's ``summary`` events; raises
    EngineTimeout / RuntimeError / ValueError."""
    base_env = dict(env if env is not None else os.environ)
    times: dict = {a: [] for a in arm_env}
    outputs: dict = {a: set() for a in arm_env}
    metrics_paths = {
        arm: os.path.join(outputs_dir,
                          f"{tag}_metrics_{arm}_c{cfg.config_id}.jsonl")
        for arm in arm_env}
    for mpath in metrics_paths.values():
        if os.path.exists(mpath):   # metrics JSONL appends; start clean
            os.remove(mpath)
    for rep in range(max(pairs, 1)):
        order = order0 if rep % 2 == 0 else tuple(reversed(order0))
        for arm in order:
            e = dict(base_env)
            e[var] = arm_env[arm]
            out_path, err_path = run_engine(
                cfg, input_path, outputs_dir, mode=mode, fast=fast,
                timeout_s=timeout_s, env=e,
                obs_flags=["--metrics", metrics_paths[arm]], device=device)
            with open(out_path) as f:
                outputs[arm].add(f.read())
            with open(err_path) as f:
                ms = _extract_ms(f.read())
            if ms is None:
                raise ValueError(f"no timing line in the {arm}-arm run")
            times[arm].append(ms)
    return times, outputs, metrics_paths


def _summaries(path: str) -> list:
    """The ``summary`` events of a metrics JSONL (raises OSError /
    ValueError when unreadable)."""
    with open(path) as f:
        return [rec for rec in (json.loads(ln) for ln in f if ln.strip())
                if rec.get("event") == "summary"]


def _launches(summary: dict) -> dict:
    """Recorded launches by kernel from a summary's counters block."""
    per = (summary.get("counters") or {}).get("per_kernel") or {}
    return {k: int(v.get("dispatches", 0)) for k, v in sorted(per.items())}


def _measure_fused_ab(cfg: BenchConfig, input_path: str,
                      outputs_dir: str, out: TextIO,
                      mode: Optional[str], fast: bool,
                      timeout_s: float, env: Optional[dict],
                      pairs: int, oracle_want: Optional[str],
                      device: str = "cuda") -> dict:
    """Interleaved fused-kernel vs two-pass engine timings (see
    run_config docstring): ``DMLP_TPU_FUSED=1`` (K1, the gate on) against
    ``=0`` (K2, the gate off), order alternating per pair. Three results
    ride in the record:

    - ``engine_ms_fused`` / ``engine_ms_two_pass`` medians plus the raw
      ``*_reps`` lists (the ledger's per-trial evidence — a gated series);
    - ``fused_ab_pct``: median fused vs two-pass (negative = fused
      faster);
    - ``fused_ab_identical``: every fused-arm stdout byte-equal to every
      two-pass-arm stdout (and to the oracle when the run is in exact
      mode) — CHECKED per run, not assumed. A mismatch marks the A/B
      unavailable (a wrong-output arm's timing must not become a ledger
      point).

    ``fused_ab_launches`` holds each arm's recorded launches by kernel
    (the last run's metrics summary). The A/B is never VACUOUS: both arms
    run with ``--metrics`` and the fused arm's summary must report
    ``extract_impl == "fused"`` — a config that never takes the fused
    path records the explicit ``fused_ab_vacuous`` marker instead of an
    identical-code pair masquerading as a gated series.

    Never raises: failures record ``fused_ab_unavailable``."""
    if cfg.procs > 1:
        return {"fused_ab_unavailable": "multi-process config (the A/B "
                "drives the single-process engine CLI)"}
    arm_env = {"fused": "1", "two_pass": "0"}
    try:
        times, outputs, metrics_paths = _env_arms(
            cfg, input_path, outputs_dir, mode, fast, timeout_s, env,
            pairs, device, "DMLP_TPU_FUSED", arm_env,
            ("two_pass", "fused"), "fused_ab")
    except ValueError as e:
        return {"fused_ab_unavailable": str(e)}
    except (EngineTimeout, RuntimeError) as e:
        return {"fused_ab_unavailable":
                f"engine run failed during the A/B: {e}"}
    impls: dict = {a: set() for a in arm_env}
    launches: dict = {}
    metrics_err = None
    for arm, mpath in metrics_paths.items():
        try:
            for rec in _summaries(mpath):
                impls[arm].add(rec.get("extract_impl"))
                launches[arm] = _launches(rec)
        except (OSError, ValueError) as e:
            metrics_err = f"{arm}-arm metrics channel unreadable: {e}"
    identical = (len(outputs["fused"]) == 1
                 and outputs["fused"] == outputs["two_pass"]
                 and (oracle_want is None
                      or outputs["fused"] == {oracle_want}))
    if not identical:
        return {"fused_ab_unavailable":
                "fused/two-pass stdout MISMATCH — bit-identity contract "
                "violated; timings withheld", "fused_ab_identical": False}
    if metrics_err is not None or not impls["fused"]:
        # The vacuity check below needs a parsed summary per arm; an
        # unreadable/empty metrics channel is an INFRASTRUCTURE failure,
        # not evidence about which kernel the config dispatches.
        return {"fused_ab_identical": True,
                "fused_ab_unavailable": metrics_err
                or "no engine summary parsed from the A/B metrics "
                   "channel — cannot attribute the arms to kernels"}
    if impls["fused"] != {"fused"}:
        return {"fused_ab_vacuous": True,
                "fused_ab_identical": True,
                "fused_ab_unavailable":
                    "the DMLP_TPU_FUSED=1 arm dispatched "
                    f"{sorted(str(i) for i in impls['fused'])} (not the "
                    "fused kernel) — this config's solve never takes "
                    "the fused path; an identical-code A/B must not "
                    "become a gated series"}
    med_f = statistics.median(times["fused"])
    med_t = statistics.median(times["two_pass"])
    res = {"fused_ab_identical": True,
           "fused_ab_impls": {a_: sorted(str(i) for i in v)
                              for a_, v in impls.items()},
           "fused_ab_launches": launches,
           "engine_ms_fused": round(med_f),
           "engine_ms_fused_reps": times["fused"],
           "engine_ms_two_pass": round(med_t),
           "engine_ms_two_pass_reps": times["two_pass"]}
    if med_t > 0:
        pct = (med_f - med_t) / med_t * 100.0
        res["fused_ab_pct"] = round(pct, 2)
        out.write(f"Config {cfg.config_id}: fused A/B {pct:+.1f}% "
                  f"(median {med_t} -> {med_f} ms over "
                  f"{len(times['fused'])} interleaved pair(s), "
                  "byte-identical)\n")
    return res


def _measure_prune_ab(cfg: BenchConfig, input_path: str,
                      outputs_dir: str, out: TextIO,
                      mode: Optional[str], fast: bool,
                      timeout_s: float, env: Optional[dict],
                      pairs: int, oracle_want: Optional[str],
                      device: str = "cuda") -> dict:
    """Interleaved pruned vs dense engine timings: ``DMLP_TPU_PRUNE=1``
    against ``=0``, order alternating per pair. The record carries:

    - ``engine_ms_pruned`` / ``engine_ms_dense`` medians plus raw
      ``*_reps`` lists (ledger per-trial evidence -> a gated
      ``prune/configN/...`` series);
    - ``scanned_bytes_pruned`` / ``scanned_bytes_dense`` /
      ``scanned_bytes_ratio`` from the engines' scan accounting (the CLI
      metrics summary's ``prune`` block) — the bytes claim as a checked
      number, both ways;
    - ``prune_ab_identical``: every pruned-arm stdout byte-equal to
      every dense-arm stdout (and the oracle in exact mode), CHECKED per
      run;
    - ``prune_ab_vacuous`` when the pruned arm pruned zero blocks
      (e.g. a uniform corpus): the timings/bytes still record — a ratio
      of 1.0 on a shape pruning cannot help is an honest measurement —
      but the flag says so.

    Never raises: failures record ``prune_ab_unavailable``."""
    if cfg.procs > 1:
        return {"prune_ab_unavailable": "multi-process config (the A/B "
                "drives the single-process engine CLI)"}
    arm_env = {"pruned": "1", "dense": "0"}
    try:
        times, outputs, metrics_paths = _env_arms(
            cfg, input_path, outputs_dir, mode, fast, timeout_s, env,
            pairs, device, "DMLP_TPU_PRUNE", arm_env, ("dense", "pruned"),
            "prune_ab")
    except ValueError as e:
        return {"prune_ab_unavailable": str(e)}
    except (EngineTimeout, RuntimeError) as e:
        return {"prune_ab_unavailable":
                f"engine run failed during the A/B: {e}"}
    identical = (len(outputs["pruned"]) == 1
                 and outputs["pruned"] == outputs["dense"]
                 and (oracle_want is None
                      or outputs["pruned"] == {oracle_want}))
    if not identical:
        return {"prune_ab_unavailable":
                "pruned/dense stdout MISMATCH — byte-identity contract "
                "violated; timings withheld", "prune_ab_identical": False}
    prune_blocks: dict = {}
    for arm, mpath in metrics_paths.items():
        try:
            for rec in _summaries(mpath):
                if isinstance(rec.get("prune"), dict):
                    prune_blocks[arm] = rec["prune"]
        except (OSError, ValueError) as e:
            return {"prune_ab_identical": True,
                    "prune_ab_unavailable":
                        f"{arm}-arm metrics channel unreadable: {e}"}
    if set(prune_blocks) != set(arm_env):
        return {"prune_ab_identical": True,
                "prune_ab_unavailable":
                    "no scan-accounting block in the A/B metrics "
                    "channel — cannot attribute scanned bytes to arms"}
    med_p = statistics.median(times["pruned"])
    med_d = statistics.median(times["dense"])
    sb_p = int(prune_blocks["pruned"].get("scanned_bytes", 0))
    sb_d = int(prune_blocks["dense"].get("scanned_bytes", 0))
    res = {"prune_ab_identical": True,
           "engine_ms_pruned": round(med_p),
           "engine_ms_pruned_reps": times["pruned"],
           "engine_ms_dense": round(med_d),
           "engine_ms_dense_reps": times["dense"],
           "scanned_bytes_pruned": sb_p,
           "scanned_bytes_dense": sb_d,
           "prune_blocks_total": prune_blocks["pruned"].get(
               "blocks_total"),
           "prune_blocks_pruned": prune_blocks["pruned"].get(
               "blocks_pruned", 0)}
    if sb_d:
        res["scanned_bytes_ratio"] = round(sb_p / sb_d, 4)
    if not res["prune_blocks_pruned"]:
        res["prune_ab_vacuous"] = True
    if med_d > 0:
        pct = (med_p - med_d) / med_d * 100.0
        res["prune_ab_pct"] = round(pct, 2)
        out.write(f"Config {cfg.config_id}: prune A/B {pct:+.1f}% "
                  f"(median {med_d} -> {med_p} ms, scanned bytes "
                  f"{sb_d} -> {sb_p}, "
                  f"{res['prune_blocks_pruned']}/"
                  f"{res['prune_blocks_total']} blocks pruned, "
                  "byte-identical)\n")
    return res


def _measure_precision_ab(cfg: BenchConfig, input_path: str,
                          outputs_dir: str, out: TextIO,
                          mode: Optional[str], fast: bool,
                          timeout_s: float, env: Optional[dict],
                          pairs: int, oracle_want: Optional[str],
                          device: str = "cuda") -> dict:
    """Interleaved bf16-first-pass vs f32 engine timings:
    ``DMLP_TPU_PRECISION=bf16`` against ``=f32``, order alternating per
    pair. The record carries:

    - ``engine_ms_bf16`` / ``engine_ms_f32`` medians plus raw
      ``*_reps`` lists (ledger per-trial evidence -> a gated
      ``precision/configN/...`` series);
    - ``precision_ab_identical``: every bf16-arm stdout byte-equal to
      every f32-arm stdout (and the oracle in exact mode), CHECKED per
      run. A mismatch withholds the timings;
    - ``precision_kcap_f32`` / ``precision_kcap_bf16`` /
      ``precision_kcap_inflation`` from the engines' per-arm
      ``precision`` summary blocks — the window-inflation cost of the
      bound, as a checked number.

    The A/B is never VACUOUS: the bf16 arm's summary must report
    ``active == "bf16"`` — a fast-mode run (precision resolves f32 when
    there is no rescore backstop) records the explicit
    ``precision_ab_unavailable`` marker instead.

    Never raises: failures record ``precision_ab_unavailable``."""
    if cfg.procs > 1:
        return {"precision_ab_unavailable": "multi-process config (the "
                "A/B drives the single-process engine CLI)"}
    arm_env = {"bf16": "bf16", "f32": "f32"}
    try:
        times, outputs, metrics_paths = _env_arms(
            cfg, input_path, outputs_dir, mode, fast, timeout_s, env,
            pairs, device, "DMLP_TPU_PRECISION", arm_env, ("f32", "bf16"),
            "precision_ab")
    except ValueError as e:
        return {"precision_ab_unavailable": str(e)}
    except (EngineTimeout, RuntimeError) as e:
        return {"precision_ab_unavailable":
                f"engine run failed during the A/B: {e}"}
    identical = (len(outputs["bf16"]) == 1
                 and outputs["bf16"] == outputs["f32"]
                 and (oracle_want is None
                      or outputs["bf16"] == {oracle_want}))
    if not identical:
        return {"precision_ab_unavailable":
                "bf16/f32 stdout MISMATCH — byte-identity contract "
                "violated; timings withheld",
                "precision_ab_identical": False}
    prec_blocks: dict = {}
    for arm, mpath in metrics_paths.items():
        try:
            for rec in _summaries(mpath):
                if isinstance(rec.get("precision"), dict):
                    prec_blocks[arm] = rec["precision"]
        except (OSError, ValueError) as e:
            return {"precision_ab_identical": True,
                    "precision_ab_unavailable":
                        f"{arm}-arm metrics channel unreadable: {e}"}
    if set(prec_blocks) != set(arm_env):
        return {"precision_ab_identical": True,
                "precision_ab_unavailable":
                    "no precision block in the A/B metrics channel — "
                    "cannot attribute the arms to first-pass dtypes"}
    if prec_blocks["bf16"].get("active") != "bf16":
        return {"precision_ab_vacuous": True,
                "precision_ab_identical": True,
                "precision_ab_unavailable":
                    "the DMLP_TPU_PRECISION=bf16 arm ran with active "
                    f"precision {prec_blocks['bf16'].get('active')!r} "
                    "(fast mode, or an engine without the lowp rung) — "
                    "an identical-code A/B must not become a gated "
                    "series"}
    med_b = statistics.median(times["bf16"])
    med_f = statistics.median(times["f32"])
    res = {"precision_ab_identical": True,
           "engine_ms_bf16": round(med_b),
           "engine_ms_bf16_reps": times["bf16"],
           "engine_ms_f32": round(med_f),
           "engine_ms_f32_reps": times["f32"]}
    for arm in arm_env:
        kcap = prec_blocks[arm].get("kcap")
        if kcap is not None:
            res[f"precision_kcap_{arm}"] = kcap
    infl = prec_blocks["bf16"].get("kcap_inflation")
    if infl is not None:
        res["precision_kcap_inflation"] = infl
    if med_f > 0:
        pct = (med_b - med_f) / med_f * 100.0
        res["precision_ab_pct"] = round(pct, 2)
        out.write(f"Config {cfg.config_id}: precision A/B {pct:+.1f}% "
                  f"(median {med_f} -> {med_b} ms over "
                  f"{len(times['bf16'])} interleaved pair(s), kcap "
                  f"{res.get('precision_kcap_f32', '?')} -> "
                  f"{res.get('precision_kcap_bf16', '?')}, "
                  "byte-identical)\n")
    return res


def _mesh_line(err_text: str) -> Optional[dict]:
    """The ``mesh:`` JSON line of a mesh run's ``--phase-times``."""
    for ln in err_text.splitlines():
        if ln.startswith("mesh: "):
            return json.loads(ln[len("mesh: "):])
    return None


def _measure_auto_ab(cfg: BenchConfig, input_path: str,
                     outputs_dir: str, out: TextIO,
                     fast: bool, timeout_s: float, env: Optional[dict],
                     pairs: int, oracle_want: Optional[str],
                     device: str = "cuda") -> dict:
    """Interleaved compiler-sharded vs hand-rolled engine timings: the
    DTensor-placed engine (``--mode auto``) against BOTH hand-written
    merges (``--mode sharded`` all-gather, ``--mode ring``), arm order
    alternating per rep. The record carries:

    - ``engine_ms_auto`` / ``engine_ms_sharded`` / ``engine_ms_ring``
      medians plus raw ``*_reps`` lists (ledger per-trial evidence ->
      a gated ``auto/configN/...`` series) and the headline
      ``auto_ab_pct_vs_sharded`` / ``auto_ab_pct_vs_ring`` deltas;
    - ``warmup_ms_*``: each arm's ``warmup`` phase (the ``--warmup``
      solve, reported via ``--phase-times``: the ranks' first launches,
      allocations and library loads). The reference records
      ``compile_ms_*`` here, its XLA compile; the port compiles nothing
      per solve, so the key says what it measures instead;
    - ``auto_ab_identical``: every arm's stdout byte-equal to every
      other arm's (and the oracle in exact mode), CHECKED per run. A
      mismatch withholds the timings;
    - ``auto_ab_degenerate_mesh``: honest marker when the config pins
      no multi-rank mesh (no cross-shard merge at all), else
      ``auto_ab_mesh_ranks``;
    - ``auto_ab_launches``: each arm's per-rank kernel launches (the
      last run's ``mesh:`` line, the warm-up solve included), and
      ``auto_ab_repairs`` each arm's queries repaired on the host;
    - ``auto_hlo_bytes_*`` / ``auto_hlo_collectives_auto``: each arm's
      recorded collective bytes (CLI ``--hlo-report``, obs.hlo) — the
      A/B compares communication volume, not just wall time
      (``auto_hlo_unavailable`` marker when a record is missing).

    Never raises: failures record ``auto_ab_unavailable``."""
    if cfg.procs > 1:
        return {"auto_ab_unavailable": "multi-process config (the A/B "
                "drives the single-process engine CLI)"}
    arms = ("auto", "sharded", "ring")
    times: dict = {a: [] for a in arms}
    warm_ms: dict = {a: [] for a in arms}
    outputs: dict = {a: set() for a in arms}
    launches: dict = {}
    repairs: dict = {}
    hlo_paths = {a: os.path.join(
        outputs_dir, f"hlo_auto_ab_{a}_config{cfg.config_id}.jsonl")
        for a in arms}
    try:
        for rep in range(max(pairs, 1)):
            order = arms if rep % 2 == 0 else tuple(reversed(arms))
            for arm in order:
                out_path, err_path = run_engine(
                    cfg, input_path, outputs_dir, mode=arm, fast=fast,
                    timeout_s=timeout_s, env=env,
                    obs_flags=["--phase-times",
                               "--hlo-report", hlo_paths[arm]],
                    device=device)
                with open(out_path) as f:
                    outputs[arm].add(f.read())
                with open(err_path) as f:
                    err_text = f.read()
                ms = _extract_ms(err_text)
                if ms is None:
                    return {"auto_ab_unavailable":
                            f"no timing line in the {arm}-arm run"}
                times[arm].append(ms)
                m = re.search(r"phase warmup:\s*([0-9.]+) ms", err_text)
                if m:
                    warm_ms[arm].append(round(float(m.group(1)), 1))
                mesh = _mesh_line(err_text)
                if mesh is not None:
                    launches[arm] = [r.get("launches", {})
                                     for r in mesh.get("ranks") or []]
                m = re.search(r"^repairs: (\d+)$", err_text, re.M)
                if m:
                    repairs[arm] = int(m.group(1))
    except (EngineTimeout, RuntimeError, ValueError) as e:
        return {"auto_ab_unavailable":
                f"engine run failed during the A/B: {e}"}
    identical = (all(len(outputs[a]) == 1 for a in arms)
                 and outputs["auto"] == outputs["sharded"]
                 == outputs["ring"]
                 and (oracle_want is None
                      or outputs["auto"] == {oracle_want}))
    if not identical:
        return {"auto_ab_unavailable":
                "auto/sharded/ring stdout MISMATCH — byte-identity "
                "contract violated; timings withheld",
                "auto_ab_identical": False}
    med = {a: statistics.median(times[a]) for a in arms}
    res: dict = {"auto_ab_identical": True, "auto_ab_launches": launches,
                 "auto_ab_repairs": repairs}
    for a in arms:
        res[f"engine_ms_{a}"] = round(med[a])
        res[f"engine_ms_{a}_reps"] = times[a]
        if warm_ms[a]:
            res[f"warmup_ms_{a}"] = round(statistics.median(warm_ms[a]))
            res[f"warmup_ms_{a}_reps"] = warm_ms[a]
    for rival in ("sharded", "ring"):
        if med[rival] > 0:
            res[f"auto_ab_pct_vs_{rival}"] = round(
                (med["auto"] - med[rival]) / med[rival] * 100.0, 2)
    # Communication-volume side of the A/B: each arm's recorded
    # collective bytes, and the auto arm's schedule (recorded outside
    # the CLI's timed region, so the timings above are unaffected).
    for a in arms:
        try:
            with open(hlo_paths[a]) as f:
                hdoc = json.loads(f.read().splitlines()[-1])
            res[f"auto_hlo_bytes_{a}"] = \
                hdoc["metrics"]["collective_bytes_total"]
            if a == "auto":
                res["auto_hlo_collectives_auto"] = sorted(
                    (hdoc["comms"].get("collective_totals") or {}))
        except Exception as e:
            res.setdefault("auto_hlo_unavailable", {})[a] = \
                f"{type(e).__name__}: {e}"
    ranks = (cfg.mesh_shape[0] * cfg.mesh_shape[1]
             if cfg.mesh_shape is not None else 1)
    if ranks <= 1:
        res["auto_ab_degenerate_mesh"] = True
    else:
        res["auto_ab_mesh_ranks"] = ranks

    def _pct(rival: str) -> str:
        v = res.get(f"auto_ab_pct_vs_{rival}")
        return f"{v:+.1f}%" if v is not None else "n/a"

    out.write(f"Config {cfg.config_id}: auto A/B {_pct('sharded')} vs "
              f"sharded, {_pct('ring')} vs ring (medians sharded "
              f"{res['engine_ms_sharded']} / ring "
              f"{res['engine_ms_ring']} -> auto "
              f"{res['engine_ms_auto']} ms over {len(times['auto'])} "
              f"interleaved rep(s), warm-up "
              f"{res.get('warmup_ms_sharded', '?')} / "
              f"{res.get('warmup_ms_ring', '?')} -> "
              f"{res.get('warmup_ms_auto', '?')} ms, byte-identical"
              + (", DEGENERATE 1x1 mesh"
                 if res.get("auto_ab_degenerate_mesh") else "")
              + ")\n")
    return res


def _append_run_record(record_path: str, cfg: BenchConfig, res: dict,
                       trace_dir: Optional[str],
                       profile: Optional[tuple] = None,
                       device: str = "cuda",
                       telemetry_dir: Optional[str] = None) -> None:
    """One versioned RunRecord per config run (obs.run).
    ``profile`` is ("path", dir) to link a capture from the artifacts
    block, or ("unavailable", why) for the explicit marker. ``device``
    is the engine's: the record carries the card's name or "cpu"."""
    import dataclasses

    from dmlp_tpu_torch.obs.run import (RunRecord, current_device,
                                        round_from_name)

    artifacts = {}
    metrics = dict(res)
    failed = bool(res.get("timeout") or res.get("error"))
    if trace_dir and cfg.procs == 1 and not failed:
        # Only paths that actually exist, and only for completed runs: a
        # timed-out/killed engine never wrote its trace.
        candidates = {
            "trace": os.path.join(
                trace_dir, f"trace_config{cfg.config_id}.json"),
            "metrics": os.path.join(
                trace_dir, f"metrics_config{cfg.config_id}.jsonl"),
        }
        artifacts = {k: p for k, p in candidates.items()
                     if os.path.exists(p)}
    if telemetry_dir and cfg.procs == 1 and not failed:
        tpath = os.path.join(telemetry_dir,
                             f"telemetry_config{cfg.config_id}.prom")
        if os.path.exists(tpath):
            artifacts["telemetry"] = tpath
    if profile is not None:
        if profile[0] == "path" and not failed:
            artifacts["profile"] = profile[1]
        else:
            metrics["profile_unavailable"] = profile[1]
    RunRecord(kind="bench", tool=TOOL,
              config=dataclasses.asdict(cfg), metrics=metrics,
              artifacts=artifacts, device=current_device(device),
              round=round_from_name(record_path)).append_jsonl(record_path)


def run_serve(base_dir: str = ".", trace_path: Optional[str] = None,
              reps: int = 2, record_path: Optional[str] = None,
              timeout_s: float = 600.0, connections: int = 4,
              max_batch_queries: int = 64,
              extra_flags: Optional[list] = None,
              out: TextIO = sys.stdout, device: str = "cuda") -> dict:
    """Serve mode: replay a recorded mixed-(nq, k) query trace against
    the real daemon (``python -m dmlp_tpu_torch.serve`` subprocess on
    ``device``) in interleaved gate-carry ON/OFF arms, and emit ONE
    schema-2 RunRecord (kind "serve" -> ledger ``serve/...`` series) with
    sustained request/query throughput, client-side latency quantiles,
    raw per-arm sample lists, and the warm-up A/B's gated-block
    fractions.

    Hard assertions, not best-effort: every response must match the
    float64 golden oracle byte-for-byte, both arms must match each
    other, the daemon's build and kernel-library load counters
    (``compile_count``, ``kernel_loads``) must not move between ready
    and drain (no per-request build), and SIGTERM must drain to exit 0
    with no flight-recorder dump."""
    import subprocess

    from dmlp_tpu_torch.io.grammar import parse_input_text
    from dmlp_tpu_torch.obs.run import (RunRecord, current_device,
                                        round_from_name)
    from dmlp_tpu_torch.serve import client as serve_client

    trace_path = trace_path or os.path.join(base_dir, "inputs",
                                            "serve_trace1.jsonl")
    header, reqs = serve_client.load_trace(trace_path)
    outputs = os.path.join(base_dir, "outputs", "serve_bench")
    os.makedirs(outputs, exist_ok=True)
    corpus_txt = serve_client.corpus_text(header)
    corpus_path = os.path.abspath(os.path.join(outputs, "corpus.in"))
    with open(corpus_path, "w") as f:
        f.write(corpus_txt)
    corpus = parse_input_text(corpus_txt)
    golden = serve_client.golden_reference(corpus, header, reqs)
    golden_text = serve_client.contract_text(golden)
    # Warm every shape bucket the replay can hit BEFORE ready — only
    # then is the build-counter assertion below meaningful.
    warm = serve_client.warm_buckets_for_trace(reqs, max_batch_queries)
    warm_spec = ",".join(f"{nq}x{k}" for nq, k in warm)

    arm_results: dict = {"on": [], "off": []}
    cold_ms: list = []
    res: dict = {"trace": trace_path, "requests": len(reqs),
                 "queries": int(sum(int(r["nq"]) for r in reqs)),
                 "checksums_match": True}
    for rep in range(max(reps, 1)):
        # Interleave arm order per rep (neither arm systematically runs
        # first).
        arms = ("on", "off") if rep % 2 == 0 else ("off", "on")
        for arm in arms:
            tag = f"rep{rep}_{arm}"
            ready = os.path.join(outputs, f"ready_{tag}.json")
            errlog = os.path.join(outputs, f"daemon_{tag}.err")
            if os.path.exists(ready):
                os.remove(ready)
            # --telemetry arms the session (and hence the flight
            # recorder, whose dump dir is the snapshot file's dir) so
            # the no-flight-dump drain assertion below has teeth.
            cmd = [sys.executable, "-m", "dmlp_tpu_torch.serve",
                   "--corpus", corpus_path, "--port", "0",
                   "--device", device,
                   "--ready-file", ready, "--gate-carry", arm,
                   "--warm-buckets", warm_spec,
                   "--max-batch-queries", str(max_batch_queries),
                   "--telemetry",
                   os.path.join(outputs, f"telemetry_{tag}.prom"),
                   "--tick-ms", "2"] + list(extra_flags or [])
            # A crash in a PREVIOUS invocation may have left flight
            # dumps here; clear them or the no-dump assertion below
            # would fail every later orderly run.
            serve_client.clear_flight_dumps(outputs)
            with open(errlog, "w") as ef:
                proc = subprocess.Popen(cmd, stderr=ef,
                                        stdout=subprocess.DEVNULL,
                                        env=_engine_env(None))
            try:
                ready_doc = serve_client.await_ready(
                    proc, ready, timeout_s=timeout_s, errlog=errlog)
                port = ready_doc["port"]
                t0 = time.perf_counter()
                responses = serve_client.replay(
                    port, header, reqs, connections=connections)
                wall_s = time.perf_counter() - t0
                bad = [r for r in responses if not r.get("ok")]
                if bad:
                    raise RuntimeError(
                        f"serve replay ({tag}): {len(bad)} failed "
                        f"responses, first: {bad[0]}")
                text = serve_client.contract_text(
                    [r["checksums"] for r in responses])
                if text != golden_text:
                    res["checksums_match"] = False
                    raise RuntimeError(
                        f"serve replay ({tag}): responses differ from "
                        "the golden oracle")
                cli = serve_client.ServeClient(port)
                stats = cli.stats()["stats"]
                cli.close()
                for key in ("compile_count", "kernel_loads"):
                    if stats["engine"][key] != ready_doc[key]:
                        raise RuntimeError(
                            f"serve replay ({tag}): {key} moved "
                            f"{ready_doc[key]} -> {stats['engine'][key]}"
                            " — a request built or loaded anew")
                serve_client.sigterm_drain(proc, errlog=errlog)
                flights = serve_client.flight_dumps(outputs)
                if flights:
                    raise RuntimeError(
                        f"orderly drain left flight dumps: {flights}")
                arm_results[arm].append({
                    "wall_s": wall_s,
                    "requests_per_sec": len(reqs) / wall_s,
                    "queries_per_sec": res["queries"] / wall_s,
                    "latency_ms": sorted(r["client_ms"]
                                         for r in responses),
                    "gated_fraction":
                        stats["engine"]["last_gated_fraction"],
                })
                cold_ms.append(ready_doc["cold_start_compile_ms"])
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)

    def _q(sorted_ms: list, q: float) -> float:
        return sorted_ms[min(int(q * (len(sorted_ms) - 1) + 0.5),
                             len(sorted_ms) - 1)]

    metrics: dict = {
        "requests": len(reqs), "trace_queries": res["queries"],
        "cold_start_compile_ms": statistics.median(cold_ms),
        "cold_start_compile_ms_reps": cold_ms,
        "connections": connections,
    }
    for arm, runs in arm_results.items():
        rps = [round(r["requests_per_sec"], 3) for r in runs]
        lat = sorted(ms for r in runs for ms in r["latency_ms"])
        metrics[f"requests_per_sec_carry_{arm}"] = statistics.median(rps)
        metrics[f"requests_per_sec_carry_{arm}_reps"] = rps
        metrics[f"queries_per_sec_carry_{arm}"] = statistics.median(
            [round(r["queries_per_sec"], 3) for r in runs])
        metrics[f"request_latency_p50_ms_carry_{arm}"] = round(
            _q(lat, 0.50), 3)
        metrics[f"request_latency_p95_ms_carry_{arm}"] = round(
            _q(lat, 0.95), 3)
        metrics[f"carry_{arm}_latency_ms"] = [round(v, 3) for v in lat]
        gf = [r["gated_fraction"] for r in runs
              if r["gated_fraction"] is not None]
        if gf:
            metrics[f"gated_fraction_carry_{arm}"] = round(
                statistics.median(gf), 6)
            metrics[f"gated_fraction_carry_{arm}_reps"] = gf
    res.update(metrics)
    out.write(
        f"Serve bench: {len(reqs)} requests x {reps} rep(s)/arm, "
        f"carry-on {metrics['requests_per_sec_carry_on']} req/s vs "
        f"carry-off {metrics['requests_per_sec_carry_off']} req/s, "
        f"p50 {metrics['request_latency_p50_ms_carry_on']} ms, "
        "all arms byte-identical to the golden oracle\n")
    if record_path:
        RunRecord(
            kind="serve", tool=TOOL,
            config={"trace": os.path.basename(trace_path),
                    "corpus": header["corpus"],
                    "connections": connections, "reps": reps,
                    "flags": list(extra_flags or [])},
            metrics=metrics, round=round_from_name(record_path),
            artifacts={"trace": trace_path},
            device=current_device(device)).append_jsonl(record_path)
    res["ok"] = True
    return res


def reference_binary_fields(cap_path: str, config_id: int,
                            engine_ms: float) -> dict:
    """Annotation fields comparing an engine time against the captured
    reference-binary run for ``config_id`` — shared by this harness and
    ``bench.driver`` so the capture-schema handling cannot drift.
    Best-effort by contract: returns {} (never raises, never partial
    fields) when the capture is absent, unreadable, or malformed — the
    annotation must not be able to discard a completed benchmark
    result."""
    try:
        with open(cap_path) as f:
            ref = json.load(f)["configs"][str(config_id)]
        ref_ms = float(ref["time_taken_ms"])  # validate; store raw below
        ref_np = int(ref["np"])
    except (OSError, KeyError, TypeError, ValueError,
            json.JSONDecodeError):
        return {}
    # `not (ref_ms > 0)` also rejects NaN (NaN <= 0 is False) — a NaN
    # multiple would serialize as invalid strict JSON downstream.
    if not engine_ms or not (ref_ms > 0):
        return {}
    return {"reference_binary_ms": ref["time_taken_ms"],
            "reference_binary_np": ref_np,
            "vs_reference_binary": round(ref_ms / engine_ms, 1)}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.bench",
                                description=__doc__)
    p.add_argument("config", help="1|2|3|4|5|all|serve ('serve' "
                                  "replays --serve-trace against the "
                                  "resident daemon)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every engine subprocess runs (default: the "
                        "card; no fallback when there is none)")
    p.add_argument("--mode", default=None,
                   choices=[None, "single", "sharded", "ring", "auto"])
    p.add_argument("--fast", action="store_true",
                   help="drop the f64 host rescore (f32 ordering; checksum "
                        "diffs vs the f64 oracle are then expected)")
    p.add_argument("--force-oracle", action="store_true")
    p.add_argument("--base-dir", default=".")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-config engine kill timeout in seconds "
                        "(mpirun --timeout 300 analog)")
    p.add_argument("--reps", type=int, default=1,
                   help="engine runs per config; >1 reports the median "
                        "and every run's time (the reference protocol is "
                        "single-shot)")
    p.add_argument("--trace", metavar="DIR", default=None, dest="trace_dir",
                   help="per-config observability capture: the engine "
                        "subprocess writes DIR/trace_configN.json "
                        "(Perfetto) + DIR/metrics_configN.jsonl")
    p.add_argument("--metrics", "--record", metavar="FILE", default=None,
                   dest="metrics",
                   help="append one versioned RunRecord (obs.run) per "
                        "config to FILE — the uniform bench artifact")
    p.add_argument("--counters", action="store_true",
                   help="engine subprocesses print the kernels' cost "
                        "counters and roofline summary on stderr")
    p.add_argument("--telemetry", metavar="DIR", default=None,
                   dest="telemetry_dir",
                   help="per-config live-telemetry capture: the engine "
                        "subprocess rewrites DIR/telemetry_configN.prom "
                        "as an OpenMetrics snapshot (obs.telemetry), "
                        "linked from the config's RunRecord artifacts")
    p.add_argument("--profile", metavar="DIR", default=None,
                   dest="profile_dir",
                   help="per-config torch.profiler capture of the timed "
                        "solve into DIR/profile_configN, linked from the "
                        "config's RunRecord artifacts")
    p.add_argument("--obs-overhead", action="store_true",
                   help="self-measure the observability layer: run "
                        "interleaved engine pairs with tracing+counters "
                        "off vs on and record obs_overhead_pct in the "
                        "config's RunRecord (single-process configs)")
    p.add_argument("--fused-ab", action="store_true",
                   help="A/B the fused distance->top-k kernel (K1) "
                        "against the gate-off extraction (K2): run "
                        "interleaved DMLP_TPU_FUSED=1/0 engine pairs, "
                        "verify the arms byte-identical, and record "
                        "engine_ms_fused / engine_ms_two_pass (+ raw "
                        "rep lists) in the config's RunRecord "
                        "(single-process configs)")
    p.add_argument("--prune-ab", action="store_true",
                   help="A/B the pruned two-stage solve: run "
                        "interleaved DMLP_TPU_PRUNE=1/0 engine pairs, "
                        "verify the arms byte-identical, and record "
                        "engine_ms_pruned / engine_ms_dense plus "
                        "scanned-bytes both ways (+ raw rep lists) as "
                        "a kind=\"prune\" RunRecord per config "
                        "(single-process configs)")
    p.add_argument("--precision-ab", action="store_true",
                   help="A/B the low-precision first pass: run "
                        "interleaved DMLP_TPU_PRECISION=bf16/f32 "
                        "engine pairs, verify the arms byte-identical "
                        "(and vs the oracle in exact mode), and record "
                        "engine_ms_bf16 / engine_ms_f32 plus the "
                        "kcap window inflation (+ raw rep lists) as a "
                        "kind=\"precision\" RunRecord per config "
                        "(single-process configs)")
    p.add_argument("--auto-ab", action="store_true",
                   help="A/B the compiler-sharded engine: run "
                        "interleaved --mode auto / sharded / ring "
                        "engine arms, verify all three byte-identical "
                        "(and vs the oracle in exact mode), and record "
                        "engine_ms_auto / engine_ms_sharded / "
                        "engine_ms_ring plus each arm's warm-up time "
                        "(+ raw rep lists) as a kind=\"auto\" RunRecord "
                        "per config (single-process configs)")
    p.add_argument("--serve-trace", metavar="FILE", default=None,
                   help="recorded query trace for the serve mode "
                        "(default inputs/serve_trace1.jsonl)")
    p.add_argument("--serve-connections", type=int, default=4,
                   help="concurrent replay connections (micro-batching "
                        "coalesces across them)")
    p.add_argument("--serve-flags", default="",
                   help="extra daemon flags, space-separated (e.g. "
                        "'--pallas --data-block 12800')")
    args = p.parse_args(argv)

    if args.config == "serve":
        res = run_serve(base_dir=args.base_dir,
                        trace_path=args.serve_trace,
                        reps=args.reps, record_path=args.metrics,
                        timeout_s=args.timeout,
                        connections=args.serve_connections,
                        extra_flags=args.serve_flags.split() or None,
                        device=args.device)
        return 0 if res.get("ok") else 1

    ids = list(BENCH_CONFIGS) if args.config == "all" else [int(args.config)]
    ok = True
    for cid in ids:
        res = run_config(cid, base_dir=args.base_dir, mode=args.mode,
                         fast=args.fast, force_oracle=args.force_oracle,
                         timeout_s=args.timeout, reps=args.reps,
                         trace_dir=args.trace_dir, counters=args.counters,
                         record_path=args.metrics,
                         profile_dir=args.profile_dir,
                         obs_overhead=args.obs_overhead,
                         fused_ab=args.fused_ab,
                         prune_ab=args.prune_ab,
                         precision_ab=args.precision_ab,
                         auto_ab=args.auto_ab,
                         telemetry_dir=args.telemetry_dir,
                         device=args.device)
        # `timed_out` is a marker, not a verdict (markers never gate):
        # the config's RunRecord documents the hang; a wrong checksum
        # still fails the run.
        ok = ok and (res["checksums_match"] or res.get("timed_out", False))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
