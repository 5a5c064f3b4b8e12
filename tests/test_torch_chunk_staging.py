"""The batch engine's host staging (``engine/single.py``): each chunk is
cast into its own host tensor inside the chunk loop. On the CPU, for
float32 and bfloat16 staging and an input whose last chunk is part
padding, the chunks that each of the four entries to the one chunk loop
(extract, routed, multi-pass, pipelined) hands to ``stage()`` are, byte
for byte, the rows of the whole padded copy the engine used to make before
the loop; each entry keeps its loop span and ``last_phase_ms`` keys; the
queries are staged as that copy's padded queries; and the multi-pass
path's resident chunks are distinct tensors, not views of one reused
buffer."""

import dataclasses

import numpy as np
import pytest
import torch

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine import single
from dmlp_tpu_torch.engine.chunks import staging_dtype
from dmlp_tpu_torch.engine.single import SingleChipEngine
from dmlp_tpu_torch.io.datagen import generate_input_text
from dmlp_tpu_torch.io.grammar import parse_input_text
from dmlp_tpu_torch.obs import trace as obs_trace

# 8,999 rows: 9 extraction chunks of 1,024 rows (the last holds 807 rows
# and 217 pad rows) and 9 streaming chunks of 1,000 (the last one pad row).
N, NQ, NA, BLOCK = 8999, 40, 6, 1024
DTYPES = ("float32", "bfloat16")
PATHS = ("extract", "routed", "multipass", "pipelined")


@pytest.fixture(scope="module")
def inp():
    base = parse_input_text(generate_input_text(N, NQ, NA, 0.0, 50.0, 1,
                                                16, 5, seed=31))
    attrs = base.data_attrs.copy()
    # Just above a bfloat16 midpoint by less than half a float32 step:
    # float64 -> float32 -> bfloat16 rounds these down to 1.0, a cast
    # that rounded once, straight from float64, up to 1.0078125.
    attrs[::97, 0] = 1.0 + 2.0 ** -8 + 2.0 ** -30
    return dataclasses.replace(base, data_attrs=attrs)


def _old_padded(src: np.ndarray, rows: int, staging: str) -> torch.Tensor:
    """The whole padded copy as the engine made it before the chunk loop:
    numpy float32 zeros, the float64 rows assigned, then the cast."""
    a = np.zeros((rows, src.shape[1]), np.float32)
    a[:len(src)] = src
    return torch.from_numpy(a).to(staging_dtype(staging))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _solve(path: str, staging: str, inp):
    """Run ``path`` on the CPU; (engine, the chunks as (lo, rows, host
    tensor as staged, what ``stage`` returned), every tensor staged)."""
    kw = dict(device="cpu", dtype=staging, data_block=BLOCK)
    if path == "pipelined":
        cfg = EngineConfig(select="topk", **kw)
    else:
        cfg = EngineConfig(use_pallas=True, select="extract", **kw)
    ks = inp.ks.copy()
    if path == "routed":
        ks[:3] = 600
    elif path == "multipass":
        ks[:] = 600
    run_inp = dataclasses.replace(inp, ks=ks)
    engine = SingleChipEngine(cfg)
    chunks, staged = [], []
    real_chunk, real_stage = engine._host_chunk, single.stage

    def host_chunk(inp_, lo, rows):
        t = real_chunk(inp_, lo, rows)
        chunks.append([lo, rows, t])
        return t

    def stage(host, device):
        out = real_stage(host, device)
        staged.append(host.clone())
        for c in chunks:
            if c[2] is host:
                c[2] = host.clone()
                c.append(out)
        return out

    engine._host_chunk = host_chunk
    mp = pytest.MonkeyPatch()
    mp.setattr(single, "stage", stage)
    try:
        if path == "multipass":
            engine.run(run_inp)
        else:
            engine.run_device_full(run_inp)
    finally:
        mp.undo()
    return engine, chunks, staged


@pytest.mark.parametrize("staging", DTYPES)
@pytest.mark.parametrize("path", PATHS)
def test_each_staged_chunk_is_the_rows_of_the_whole_padded_copy(
        path, staging, inp):
    engine, chunks, _ = _solve(path, staging, inp)
    took = {"extract": engine.last_hetk is None
            and not engine.last_mp_passes,
            "routed": engine.last_hetk == (NQ - 3, 3),
            "multipass": engine.last_mp_passes >= 2,
            "pipelined": engine._last_select == "topk"}
    assert took[path]
    rows = chunks[0][1]
    assert all(c[1] == rows for c in chunks)
    los = [c[0] for c in chunks]
    # Every live chunk staged once, in order; the last one part padding.
    assert los == sorted(set(los))
    assert set(range(0, N, rows)) <= set(los)
    assert max(lo for lo in los if lo < N) + rows > N
    whole = _old_padded(inp.data_attrs, max(los) + rows, staging)
    for lo, _, host, _ in chunks:
        assert host.dtype == staging_dtype(staging)
        assert host.shape == (rows, NA)
        assert torch.equal(_bits(host), _bits(whole[lo:lo + rows])), lo


# Each entry's chunk loop span (none around the multi-pass first pass)
# and its arguments for this input, and the keys of ``last_phase_ms``:
# what each entry showed before the four loops became one.
LOOP_SPANS = {
    "extract": ("single.enqueue_extract",
                {"chunks": 9, "kc": 32, "impl": "fused", "scheduled": 9}),
    "routed": ("single.enqueue_extract",
               {"chunks": 9, "kc": 32, "impl": "fused", "scheduled": 9,
                "outliers": 3}),
    "multipass": (None, None),
    "pipelined": ("single.enqueue_pipelined",
                  {"select": "topk", "chunks": 9, "scheduled": 9,
                   "qblocks": 1, "k": 32}),
}
PHASES = {"prune", "copy", "pin", "launch", "chunk_wait", "enqueue",
          "fetch", "finalize"}


@pytest.mark.parametrize("path", PATHS)
def test_one_chunk_loop_keeps_each_entrys_chunks_span_and_phases(path, inp):
    """The four single-engine entries on ``engine.chunks.fold_chunks``:
    each stages every chunk of its data once, in order, byte for byte the
    rows of the whole padded copy; its loop span keeps its name and
    arguments, with every chunk's cast under it; ``last_phase_ms`` keeps
    its keys."""
    tracer = obs_trace.install(obs_trace.Tracer())
    try:
        engine, chunks, _ = _solve(path, "float32", inp)
    finally:
        obs_trace.uninstall()
    rows = chunks[0][1]
    assert [c[0] for c in chunks] == list(range(0, N, rows))
    whole = _old_padded(inp.data_attrs, N - N % rows + rows, "float32")
    for lo, _, host, _ in chunks:
        assert torch.equal(_bits(host), _bits(whole[lo:lo + rows])), lo
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    loops = [e for e in spans if e["name"].startswith("single.enqueue")]
    name, args = LOOP_SPANS[path]
    if name is None:
        assert loops == []
    else:
        assert [e["name"] for e in loops] == [name]
        got = loops[0]["args"]
        assert {k: got[k] for k in args} == args
        assert set(got) - set(args) == {"id", "parent", "h2d_bytes",
                                        "host_cast_bytes"}
        casts = [e for e in spans if e["name"] == "single.host_copy"
                 and e["args"]["parent"] == got["id"]]
        assert len(casts) == len(chunks)
    assert set(engine.last_phase_ms) == PHASES


@pytest.mark.parametrize("staging", DTYPES)
def test_the_queries_are_staged_as_the_padded_copy(staging, inp):
    _, chunks, staged = _solve("extract", staging, inp)
    queries = [t for t in staged
               if not any(torch.equal(t, c[2]) for c in chunks)]
    assert len(queries) == 1
    want = _old_padded(inp.query_attrs, len(queries[0]), staging)
    assert len(queries[0]) >= NQ
    assert torch.equal(_bits(queries[0]), _bits(want))


@pytest.mark.parametrize("staging", DTYPES)
def test_the_multipass_resident_chunks_are_distinct_tensors(staging, inp):
    """On the CPU ``stage()`` hands the host tensor itself on, and the
    multi-pass path keeps every staged chunk resident until its sweep:
    each must own its memory."""
    _, chunks, _ = _solve("multipass", staging, inp)
    resident = [c[3] for c in chunks]
    assert len(resident) == -(-N // chunks[0][1]) > 1
    ptrs = {t.untyped_storage().data_ptr() for t in resident}
    assert len(ptrs) == len(resident)
    for _, _, host, out in chunks:
        assert torch.equal(_bits(out), _bits(host))
