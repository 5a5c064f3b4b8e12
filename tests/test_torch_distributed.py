"""The port's multi-process entry points against the reference's: the
sharded file feed (``parallel.distributed``), ``python -m
dmlp_tpu_torch.distributed`` on 2 and 4 gloo processes, its supervisor
(``resilience.supervise``), and the mesh modes of ``python -m
dmlp_tpu_torch``. Every rank is a real process on the CPU with a 60 s
process-group timeout, and every subprocess is waited on with a
deadline; stdout must equal the golden oracle's byte for byte."""

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu import cli as ref_cli  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu.io.grammar import format_input, parse_input_text  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu.parallel import distributed as ref_dist  # noqa: E402
from dmlp_tpu_torch.parallel import distributed as pdist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dmlp_tpu")


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("PYTHONPATH", None)
    return env


def _finish(procs, timeout=180):
    """Wait for every process (killing the rest on a deadline); returns
    [(rc, stdout, stderr)]."""
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _hetk_text(seed, n, nq, na, hi, kmax, wide):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, hi, (n, na))
    queries = rng.uniform(0, hi, (nq, na))
    labels = rng.integers(0, 5, n).astype(np.int32)
    ks = rng.integers(1, kmax, nq).astype(np.int32)
    for i, k in wide.items():
        ks[i] = k
    return format_input(KNNInput(Params(n, nq, na), labels, data, ks,
                                 queries))


def test_shard_bounds_and_line_offsets_equal_reference():
    for n in (0, 1, 7, 64, 101, 1000):
        for p in (1, 2, 3, 8):
            for i in range(p):
                assert pdist.shard_bounds(n, p, i) == \
                    ref_dist.shard_bounds(n, p, i)
    data = b"a\nbb\n\nccc\n"
    assert pdist.line_offsets(data).tolist() == \
        ref_dist.line_offsets(data).tolist() == [0, 2, 5, 6, 10]


def test_read_data_shard_equals_reference(tmp_path):
    """Rank r's rows are shard_bounds(n, R, r), bit for bit the
    reference's read of the same file, the queries replicated."""
    text = generate_input_text(53, 9, 4, -3, 3, 1, 8, 3, seed=12)
    path = tmp_path / "in.txt"
    path.write_text(text)
    for shard in range(4):
        got = pdist.read_data_shard(str(path), 4, shard)
        want = ref_dist.read_data_shard(str(path), 4, shard)
        assert got[0].num_data == want[0].num_data == 53
        assert got[3] == want[3] == pdist.shard_bounds(53, 4, shard)[0]
        for g, w in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
            assert np.array_equal(g, w)


def test_padded_shard_and_plan_shapes():
    """A shard pads to the plan's rows with sentinel rows (label = id =
    -1), its ids counting up from its start."""
    attrs = np.arange(6, dtype=np.float64).reshape(3, 2)
    a, lab, ids = pdist.padded_shard(np.array([4, 5, 6]), attrs, 10, 8)
    assert a.shape == (8, 2) and np.array_equal(a[:3], attrs)
    assert lab.tolist() == [4, 5, 6] + [-1] * 5
    assert ids.tolist() == [10, 11, 12] + [-1] * 5
    with pytest.raises(ValueError):
        pdist.padded_shard(lab, np.zeros((9, 2)), 0, 8)


def test_rescore_counts_the_queries_it_repairs():
    """``rescore_local_shards`` returns how many queries it solved exactly:
    lists cut at k (kth == last: every real query a hazard, the padded
    query rows none) are all repaired, to the float64 top-k of the shard;
    lists with room past a wide gap repair nothing. Exact equality."""
    rng = np.random.default_rng(5)
    n, nq, qloc, na, k = 40, 6, 8, 3, 4
    attrs = rng.integers(0, 50, (n, na)).astype(np.float64)
    queries = rng.integers(0, 50, (nq, na)).astype(np.float64)
    local = {"attrs": attrs, "labels": np.arange(n, dtype=np.int32) % 5,
             "start": 100, "query_attrs": queries}
    ks = np.full(nq, k, np.int32)
    d64 = ((queries[:, None, :] - attrs[None]) ** 2).sum(-1)
    exact = [pdist._exact_shard_topk(q, attrs, local["labels"],
                                     np.arange(100, 100 + n, dtype=np.int32),
                                     k) for q in queries]

    def lists(kcap, far):
        d = np.full((qloc, kcap), np.inf, np.float32)
        ids = np.full((qloc, kcap), -1, np.int32)
        for j in range(nq):
            order = np.lexsort((-np.arange(n), d64[j]))[:kcap]
            d[j] = d64[j][order]
            ids[j] = order + 100
            d[j, k:] = far     # a list whose tail lies far past its kth
        return d, np.zeros_like(ids), ids

    (got_d, got_l, got_i), repaired = pdist.rescore_local_shards(
        lists(k, None), local, ks, 0)
    assert repaired == nq
    for j in range(nq):
        assert np.array_equal(got_d[j], exact[j][0])
        assert np.array_equal(got_i[j], exact[j][2])
    _, repaired = pdist.rescore_local_shards(lists(k + 2, 1e9), local, ks, 0)
    assert repaired == 0


def _rank_cmd(path, *extra):
    return [sys.executable, "-m", "dmlp_tpu_torch.distributed", "--input",
            str(path), "--device", "cpu", *extra]


def test_two_process_contract_run_matches_golden(tmp_path):
    """2 processes with explicit --coordinator/--processes/--process-id:
    rank 0 prints golden's bytes and Time taken, rank 1 nothing."""
    text = generate_input_text(211, 23, 5, -4, 4, 1, 12, 4, seed=9)
    path = tmp_path / "in.txt"
    path.write_text(text)
    port = pdist.free_port()
    procs = [subprocess.Popen(
        _rank_cmd(path, "--coordinator", f"localhost:{port}",
                  "--processes", "2", "--process-id", str(i)),
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = _finish(procs)
    assert [o[0] for o in outs] == [0, 0], [o[2][-2000:] for o in outs]
    assert outs[0][1] == format_results(knn_golden(parse_input_text(text)))
    assert outs[1][1] == ""
    assert re.search(r"^Time taken: \d+ ms$", outs[0][2], re.M)


def test_hetk_routing_under_torchrun_env_matches_golden(tmp_path):
    """The router's split on 2 processes that read torchrun's environment
    (--auto): the bulk on the per-shard kernel (the plain version here),
    the wide-k outlier through the streaming select."""
    text = _hetk_text(92, 640, 8, 3, 30, 20, {5: 640})
    path = tmp_path / "hetk.txt"
    path.write_text(text)
    port = pdist.free_port()
    procs = [subprocess.Popen(
        _rank_cmd(path, "--auto", "--select", "extract", "--pallas"),
        cwd=ROOT, env=_env(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                           WORLD_SIZE="2", RANK=str(i), LOCAL_RANK=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = _finish(procs)
    assert [o[0] for o in outs] == [0, 0], [o[2][-2000:] for o in outs]
    assert outs[0][1] == format_results(knn_golden(parse_input_text(text)))


def test_four_process_supervised_run_matches_golden(tmp_path):
    """``--supervise 4`` starts a healthy (2, 2) cluster: rank 0's bytes
    are golden's, including a wide-k outlier routed off the kernel."""
    text = _hetk_text(91, 700, 12, 4, 40, 25, {3: 600, 9: 700})
    path = tmp_path / "in4.txt"
    path.write_text(text)
    p = subprocess.run(
        _rank_cmd(path, "--supervise", "4", "--mesh", "2,2", "--pallas",
                  "--phase-times", "--supervise-dir", str(tmp_path / "sup")),
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout == format_results(knn_golden(parse_input_text(text)))
    assert "supervise:" not in p.stderr
    # --phase-times: the repairs summed over the ranks, and each rank's.
    lines = p.stderr.splitlines()
    repairs = int(next(ln for ln in lines if ln.startswith("repairs: "))
                  .split()[1])
    mesh = json.loads(next(ln for ln in lines
                           if ln.startswith("mesh: "))[len("mesh: "):])
    assert len(mesh["ranks"]) == 4
    assert repairs == sum(rk["repairs"] for rk in mesh["ranks"])


def test_supervised_killed_rank_relaunches_then_degrades(tmp_path, capsys,
                                                        monkeypatch):
    """A fault schedule kills rank 1 (an oom at ``dist.rank_solve``, which
    no retry takes) in every launch: the supervisor relaunches once, then
    degrades to the in-process one-rank solve — golden's bytes all the
    same — and ``resilience.stats`` records the restart and the
    degradation."""
    from dmlp_tpu_torch import distributed as entry
    from dmlp_tpu_torch.resilience import stats

    text = generate_input_text(193, 17, 4, -3, 3, 1, 10, 4, seed=13)
    path = tmp_path / "in.txt"
    path.write_text(text)
    sched = tmp_path / "kill.json"
    sched.write_text(json.dumps({"schema": 1, "seed": 0, "faults": [
        {"site": "dist.rank_solve", "kind": "oom", "when": {"rank": 1}}]}))
    stats.reset()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = entry.main(["--input", str(path), "--device", "cpu",
                     "--supervise", "2", "--faults", str(sched),
                     "--supervise-timeout", "120",
                     "--supervise-dir", str(tmp_path / "sup")])
    captured = capsys.readouterr()
    assert rc == 0
    assert captured.out == format_results(knn_golden(parse_input_text(text)))
    assert "supervise: launch 0 failed" in captured.err
    assert "supervise: launch 1 failed" in captured.err
    assert "degraded to single-process" in captured.err
    snap = stats.snapshot()
    assert snap["restarts"] == 1
    assert snap["degradations"] == ["cluster->single-process"]
    err1 = (tmp_path / "sup" / "rank1.a0.err").read_text()
    assert "RESOURCE_EXHAUSTED (injected) at dist.rank_solve" in err1


def test_mesh_cli_matches_reference_and_imports_no_reference(tmp_path):
    """``python -m dmlp_tpu_torch --mode ring --mesh 2,2 --pallas`` in a
    fresh interpreter (rank 0, which starts ranks 1-3): golden's bytes,
    the reference CLI's (``--mode ring --mesh 4,2`` on its virtual
    devices), the Time taken line, the mesh record of --phase-times, and
    afterwards no jax / jaxlib / dmlp_tpu module in rank 0's
    sys.modules."""
    text = _hetk_text(93, 18000, 40, 6, 50, 16, {7: 900})
    src = tmp_path / "in.txt"
    src.write_text(text)
    argv = ["dmlp_tpu_torch", "--device", "cpu", "--mode", "ring", "--mesh",
            "2,2", "--pallas", "--phase-times"]
    probe = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('dmlp_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
    with open(src) as f:
        p = subprocess.run([sys.executable, "-c", probe], stdin=f,
                           capture_output=True, text=True, cwd=ROOT,
                           env=_env(), timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    out, err = io.StringIO(), io.StringIO()
    assert ref_cli.main(["--mode", "ring", "--mesh", "4,2", "--pallas"],
                        stdin=io.StringIO(text), stdout=out,
                        stderr=err) == 0
    assert p.stdout == out.getvalue()
    assert p.stdout == format_results(knn_golden(parse_input_text(text)))
    lines = [ln for ln in p.stderr.splitlines() if "socket.cpp" not in ln]
    assert re.fullmatch(r"Time taken: \d+ ms", lines[0])
    mesh = json.loads(next(ln for ln in lines
                           if ln.startswith("mesh: "))[len("mesh: "):])
    assert mesh["shape"] == [2, 2] and mesh["backend"] == "gloo"
    assert [r["coords"] for r in mesh["ranks"]] == [[0, 0], [0, 1], [1, 0],
                                                    [1, 1]]
    assert "hetk: [39, 1]" in lines
    assert lines[-1] == "FORBIDDEN=[]"


def test_backend_choice_is_explicit():
    """NCCL takes one card per rank: more ranks than cards raise before
    any group starts and name the flag that picks gloo; NCCL on the CPU is
    refused; the defaults are nccl on cuda and gloo on cpu."""
    import torch
    cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="--backend gloo"):
        pdist.resolve_backend("cuda", "nccl", cards + 1)
    with pytest.raises(ValueError, match="cuda"):
        pdist.resolve_backend("cpu", "nccl")
    assert pdist.resolve_backend("cpu", None) == "gloo"
    assert pdist.resolve_backend("cuda", "gloo", 8) == "gloo"
    assert 0 < pdist.DEFAULT_TIMEOUT_S < float("inf")
