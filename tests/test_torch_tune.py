"""The port's tune cache and sweep (``dmlp_tpu_torch.tune``).

The cache: round trip, ``validate_doc``, buckets with qb, a corrupt or
misfit entry that misses only itself, the reference's file rejected (and
the port's by the reference), an absent cache that changes nothing and
makes no CUDA call, ``suppressed`` and the ``heuristic`` rung that reads
nothing. The sweep: ``python -m dmlp_tpu_torch.tune --smoke`` on the CPU
writes a file that ``--validate`` accepts and that an engine then honours
on the plain path — the cached S, G and scoring chunk, the same bytes.
"""

import io
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dmlp_tpu.tune import cache as ref_cache  # noqa: E402
from dmlp_tpu_torch import cli, kernels  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.engine import single  # noqa: E402
from dmlp_tpu_torch.golden.fast import knn_golden_fast  # noqa: E402
from dmlp_tpu_torch.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu_torch.io.report import format_results  # noqa: E402
from dmlp_tpu_torch.ops import dist_segmin as ds  # noqa: E402
from dmlp_tpu_torch.ops import extract as ex  # noqa: E402
from dmlp_tpu_torch.ops import summaries  # noqa: E402
from dmlp_tpu_torch.resilience import inject, stats  # noqa: E402
from dmlp_tpu_torch.tune import __main__ as tune_cli  # noqa: E402
from dmlp_tpu_torch.tune import cache, sweep  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_cache_state(monkeypatch, tmp_path):
    """Each test starts with no cache file at the lookup path, an empty
    memo and zero counts."""
    monkeypatch.setenv("DMLP_TPU_TUNE_CACHE", str(tmp_path / "none.json"))
    for var in ("DMLP_TPU_FUSED", "DMLP_TPU_PRUNE", "DMLP_TPU_PRECISION",
                "DMLP_TPU_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    cache.clear_lookup_memo()
    cache.reset_stats()
    yield
    cache.clear_lookup_memo()
    cache.reset_stats()


def _point(**over):
    p = dict(qb=10016, b=50176, a=64, kc=48, dtype="float32",
             precision="f32")
    p.update(over)
    return p


def test_round_trip_and_validate(tmp_path):
    c = cache.VariantCache()
    key = c.put("fused_topk", "NVIDIA H100 80GB HBM3", {"splits": 2},
                measured_ms=1.5, heuristic_ms=1.7, swept=11, **_point())
    assert key == ("fused_topk|NVIDIA H100 80GB HBM3|q16384|b65536|a64|kc48"
                   "|float32|f32")
    c.put("fused_dist_segmin", "cpu", {"group": 3}, **_point(kc=0))
    c.put("prune_score", "cpu", {"tile_q": 4}, **_point(kc=0,
                                                        dtype="float64"))
    path = c.save(str(tmp_path / "v.json"))
    doc = json.loads(open(path).read())
    cache.VariantCache.validate_doc(doc)
    back = cache.VariantCache.load(path)
    assert back.entries == c.entries
    assert back.get("fused_topk", "NVIDIA H100 80GB HBM3",
                    **_point(qb=9000, b=40000)) == {"splits": 2}
    assert back.entries[key]["measured_ms"] == 1.5
    with pytest.raises(ValueError):
        c.put("fused_topk", "cpu", {"group": 2}, **_point())
    with pytest.raises(ValueError):
        c.put("fused_topk", "cpu", {"splits": 0}, **_point())
    with pytest.raises(ValueError):
        c.put("nope", "cpu", {"splits": 2}, **_point())


def test_buckets_carry_qb():
    """Config 4's S (10,016 queries) must not reach the multi-pass shape
    (1,024 queries) at the same b bucket and kc."""
    c = cache.VariantCache()
    c.put("fused_topk", "cpu", {"splits": 2}, **_point(kc=512))
    assert c.get("fused_topk", "cpu", **_point(kc=512, qb=16000)) \
        == {"splits": 2}
    assert c.get("fused_topk", "cpu", **_point(kc=512, qb=1024)) is None
    assert c.get("extract_topk", "cpu", **_point(kc=512)) is None
    assert c.get("fused_topk", "cpu", **_point(kc=512, b=204800)) is None
    assert c.get("fused_topk", "cpu",
                 **_point(kc=512, precision="bf16")) is None


@pytest.mark.parametrize("doc,why", [
    ("[]", "not a JSON object"),
    ('{"schema": 2, "kernel": "dmlp_tpu_torch_variants", "entries": {}}',
     "schema-1"),
    ('{"schema": 1, "kernel": "pallas_topk", "entries": {}}', "schema-1"),
    ('{"schema": 1, "kernel": "dmlp_tpu_torch_variants"}', "entries"),
    ('{"schema": 1, "kernel": "dmlp_tpu_torch_variants", "entries": '
     '{"x|cpu|q1|b1|a1|kc0|float32|f32": {"variant": {"splits": 1}}}}',
     "namespace"),
    ('{"schema": 1, "kernel": "dmlp_tpu_torch_variants", "entries": '
     '{"fused_topk|cpu|q1|b1|a1|kc0|float32|f16": '
     '{"variant": {"splits": 1}}}}', "precision"),
    ('{"schema": 1, "kernel": "dmlp_tpu_torch_variants", "entries": '
     '{"fused_topk|cpu|q1|b1|a1|kc0|float32|f32": '
     '{"variant": {"splits": true}}}}', "invalid variant"),
])
def test_validate_doc_rejects(doc, why, tmp_path):
    with pytest.raises(ValueError, match=why):
        cache.VariantCache.validate_doc(json.loads(doc))
    path = tmp_path / "bad.json"
    path.write_text(doc)
    assert tune_cli.main(["--validate", str(path)]) == 1


def test_neither_package_loads_the_others_file(tmp_path, monkeypatch):
    ref_path = str(tmp_path / "ref.json")
    rc = ref_cache.VariantCache()
    rc.put("cpu", 50176, 48, {"tile_q": 32, "ne": 1, "unroll": 1}, a=64)
    rc.save(ref_path)
    with pytest.raises(ValueError):
        cache.VariantCache.load(ref_path)
    monkeypatch.setenv("DMLP_TPU_TUNE_CACHE", ref_path)
    assert cache.lookup_variant("fused_topk", device="cpu", **_point()) \
        is None
    port_path = str(tmp_path / "port.json")
    c = cache.VariantCache()
    c.put("fused_topk", "cpu", {"splits": 2}, **_point())
    c.save(port_path)
    with pytest.raises(ValueError):
        ref_cache.VariantCache.load(port_path)


def _write(tmp_path, monkeypatch, entries):
    c = cache.VariantCache()
    for kernel, variant, point in entries:
        c.put(kernel, "cpu", variant, **point)
    path = c.save(str(tmp_path / "tuned.json"))
    monkeypatch.setenv("DMLP_TPU_TUNE_CACHE", path)
    cache.clear_lookup_memo()
    return path


def test_corrupt_entry_misses_only_itself(tmp_path, monkeypatch):
    path = _write(tmp_path, monkeypatch, [
        ("fused_topk", {"splits": 3}, _point()),
        ("extract_topk", {"splits": 4}, _point())])
    doc = json.loads(open(path).read())
    key = cache.make_key("fused_topk", "cpu", **_point())
    doc["entries"][key]["variant"] = {"splits": "three"}
    open(path, "w").write(json.dumps(doc))
    cache.clear_lookup_memo()
    assert cache.lookup_variant("fused_topk", device="cpu", **_point()) \
        is None
    assert cache.lookup_variant("extract_topk", device="cpu",
                                **_point()) == {"splits": 4}


def test_misfit_falls_through_to_the_heuristic(tmp_path, monkeypatch):
    """An S the launch cannot take (more splits than blocks, a merge past
    its entries) and a G past the segment count fall back to the
    heuristic; a fitting entry is taken."""
    _write(tmp_path, monkeypatch, [
        ("fused_topk", {"splits": 7}, _point(qb=32, b=1024, a=8, kc=24)),
        ("extract_topk", {"splits": 3}, _point(qb=32, b=1024, a=8, kc=24)),
        ("fused_dist_segmin", {"group": 9},
         _point(qb=16, b=1024, a=8, kc=0)),
        ("fused_dist_segmin", {"group": 2},
         _point(qb=16, b=2048, a=8, kc=0))])
    kw = dict(device="cpu", precision="f32")
    assert ex.resolve_splits(32, 1024, 8, 24, gate=True, **kw) == 1
    assert ex.resolve_splits(32, 1024, 8, 24, gate=False, **kw) == 3
    assert ds.resolve_group(16, 1024, 8, **kw) == 1024 // ds.SEG
    assert ds.resolve_group(16, 2048, 8, **kw) == 2


def test_entries_carry_the_kernel_source_hash(tmp_path, monkeypatch):
    """K1/K2's entries carry the hash their library is named by
    (extract_topk.cu and the nvcc flags): a cache written for another
    source, or before the stamp, is a miss and the heuristic serves; K3's
    G and the scoring chunk carry none. The envelope's rules do not
    change."""
    k1 = _point(qb=32, b=1024, a=8, kc=24)
    path = _write(tmp_path, monkeypatch, [
        ("fused_topk", {"splits": 3}, k1), ("extract_topk", {"splits": 3}, k1),
        ("fused_dist_segmin", {"group": 2}, _point(qb=16, b=2048, a=8, kc=0)),
        ("prune_score", {"tile_q": 4}, _point(kc=0, dtype="float64"))])
    doc = json.loads(open(path).read())
    stamp = kernels.source_hash("extract_topk")
    for key, e in doc["entries"].items():
        assert e.get("source") == (stamp if key.split("|")[0] in (
            "fused_topk", "extract_topk") else None)
    kw = dict(device="cpu", precision="f32")

    def resolved():
        cache.clear_lookup_memo()
        return (ex.resolve_splits(32, 1024, 8, 24, gate=True, **kw),
                ex.resolve_splits(32, 1024, 8, 24, gate=False, **kw),
                ds.resolve_group(16, 2048, 8, **kw))

    assert resolved() == (3, 3, 2)
    # The same file after an edit of the kernel's source.
    real = kernels.source_path
    edited = tmp_path / "extract_topk.cu"
    edited.write_bytes(real("extract_topk").read_bytes() + b"// edited\n")
    monkeypatch.setattr(kernels, "source_path", lambda n: edited
                        if n == "extract_topk" else real(n))
    assert kernels.source_hash("extract_topk") != stamp
    assert resolved() == (1, 1, 2)
    monkeypatch.setattr(kernels, "source_path", real)
    assert resolved() == (3, 3, 2)
    # Entries written for another source, or before the stamp.
    doc["entries"][cache.make_key("fused_topk", "cpu", **k1)]["source"] = \
        "0" * 16
    del doc["entries"][cache.make_key("extract_topk", "cpu", **k1)]["source"]
    open(path, "w").write(json.dumps(doc))
    cache.VariantCache.validate_doc(doc)
    assert tune_cli.main(["--validate", path]) == 0
    assert resolved() == (1, 1, 2)


def test_absent_cache_makes_no_cuda_call_and_changes_nothing(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("the lookup touched CUDA")

    for fn in ("get_device_name", "current_device", "get_device_properties",
               "is_available"):
        monkeypatch.setattr(torch.cuda, fn, no_cuda)
    assert cache.lookup_variant("fused_topk", device="cuda",
                                **_point()) is None
    assert cache.STATS == {"lookups": 1, "hits": 0}
    inp, flags = _smoke_input("extract")
    eng = single.SingleChipEngine(_cfg(flags))
    text = format_results(eng.run(inp))
    assert text == format_results(knn_golden_fast(inp))
    assert cache.STATS["lookups"] > 0 and cache.STATS["hits"] == 0


def test_cuda_kind_is_read_only_once_a_file_has_entries(tmp_path,
                                                        monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: calls.append(i) or "Card X")
    empty = cache.VariantCache().save(str(tmp_path / "empty.json"))
    monkeypatch.setenv("DMLP_TPU_TUNE_CACHE", empty)
    assert cache.lookup_variant("fused_topk", device="cuda",
                                **_point()) is None
    assert calls == []
    c = cache.VariantCache()
    c.put("fused_topk", "Card X", {"splits": 2}, **_point())
    monkeypatch.setenv("DMLP_TPU_TUNE_CACHE",
                       c.save(str(tmp_path / "x.json")))
    assert cache.lookup_variant("fused_topk", device="cuda",
                                **_point()) == {"splits": 2}
    assert cache.lookup_variant("fused_topk", device="cuda:0",
                                **_point()) == {"splits": 2}
    assert calls == [0]          # memoized


def test_suppressed_nests():
    with cache.suppressed():
        with cache.suppressed():
            pass
        assert cache.lookup_variant("fused_topk", device="cpu",
                                    **_point()) is None
    assert cache.STATS["lookups"] == 0
    cache.lookup_variant("fused_topk", device="cpu", **_point())
    assert cache.STATS["lookups"] == 1


# -- the smoke sweep and an engine that honours its file ---------------------

def _smoke_input(path, seed=3):
    """The smoke sweep's launch shapes: 1,024 rows of 8 attributes, 16
    queries, k up to 8 (kc 24); the extraction path in 2 chunks of 512
    rows, the seg fold in one chunk of 1,024."""
    rng = np.random.default_rng(seed)
    n, nq, na = 1024, 16, 8
    data = rng.uniform(0, 100, (n, na))
    ks = rng.integers(1, 9, nq).astype(np.int32)
    ks[0] = 8
    inp = KNNInput(Params(n, nq, na), rng.integers(0, 5, n).astype(np.int32),
                   data, ks, rng.uniform(0, 100, (nq, na)))
    flags = {"extract": dict(select="extract", use_pallas=True,
                             data_block=512),
             "seg": dict(select="seg", use_pallas=True)}[path]
    return inp, flags


def _cfg(flags):
    return EngineConfig(device="cpu", **flags)


def _spy(monkeypatch):
    seen = {"splits": [], "group": [], "chunk": []}
    plain, seg_plain, mask = (ex.extract_topk_plain,
                              ds.fused_dist_segmin_plain, single.prune_mask)

    def extract_plain(*a, splits=1, **k):
        seen["splits"].append(splits)
        return plain(*a, splits=splits, **k)

    def seg(*a):
        seen["group"].append(a[4])
        return seg_plain(*a)

    def prune(*a, block_chunk=None, **k):
        seen["chunk"].append(block_chunk)
        return mask(*a, block_chunk=block_chunk, **k)

    monkeypatch.setattr(ex, "extract_topk_plain", extract_plain)
    monkeypatch.setattr(ds, "fused_dist_segmin_plain", seg)
    monkeypatch.setattr(single, "prune_mask", prune)
    return seen


def test_smoke_writes_a_valid_file_the_engine_honours(tmp_path, monkeypatch,
                                                      capsys):
    path = str(tmp_path / "smoke.json")
    assert tune_cli.main(["--smoke", "--out", path]) == 0
    out = capsys.readouterr().out.splitlines()
    summary = json.loads(out[-1])
    assert summary["device_kind"] == "cpu"
    assert {w["kernel"] for w in summary["winners"]} == {
        "fused_topk", "extract_topk", "fused_dist_segmin", "prune_score"}
    assert any(json.loads(ln).get("phase") == "split_sweep"
               for ln in out[1:-1])
    assert tune_cli.main(["--validate", path]) == 0
    # Make every winner differ from the heuristic, so honouring shows.
    doc = json.loads(open(path).read())
    for key, e in doc["entries"].items():
        knob = cache.KNOBS[key.split("|")[0]]
        e["variant"] = {knob: {"splits": 2, "group": 2, "tile_q": 1}[knob]}
    open(path, "w").write(json.dumps(doc))
    cache.VariantCache.validate_doc(doc)

    for name in ("extract", "seg"):
        inp, flags = _smoke_input(name)
        want = format_results(single.SingleChipEngine(_cfg(flags)).run(inp))
        seen = _spy(monkeypatch)
        monkeypatch.setenv("DMLP_TPU_TUNE_CACHE", path)
        cache.clear_lookup_memo()
        cache.reset_stats()
        eng = single.SingleChipEngine(_cfg(flags))
        got = format_results(eng.run(inp))
        assert got == want == format_results(knn_golden_fast(inp))
        assert cache.STATS["hits"] > 0
        if name == "extract":
            assert seen["splits"] == [2, 2]  # both chunks' launches
            assert seen["chunk"] == [1]      # 2 chunks scored, chunk 1
        else:
            assert seen["group"] == [2]      # one chunk: nothing to score
        monkeypatch.undo()


def test_cached_scoring_chunk_keeps_every_survivor_mask():
    rng = np.random.default_rng(9)
    n, nq, na, block = 4096, 30, 6, 512
    data = rng.uniform(0, 5, (n, na)) + 40.0 * (np.arange(n) // block)[:,
                                                                       None]
    q = rng.uniform(0, 5, (nq, na))
    q[-1] = data[n - 10]
    ks = rng.integers(1, 17, nq)
    summ = summaries.build_summaries(data, [(i, i + block)
                                            for i in range(0, n, block)])
    rec = sweep.sweep_prune_score(q, ks, summ, reps=1)
    want, stats_ = summaries.prune_mask(q, ks, summ)
    assert 0 < stats_["blocks_pruned"] < summ.n_blocks
    for chunk in (1, 2, 3, 4, 8, 16, rec["variant"]["tile_q"]):
        got, _ = summaries.prune_mask(q, ks, summ, block_chunk=chunk)
        assert np.array_equal(got, want), chunk
    assert rec["changed"] == [] and rec["swept"] == 6


def test_split_sweep_holds_every_s_against_the_heuristic():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.uniform(0, 1, (40, 6)).astype(np.float32))
    d0, d1 = (torch.from_numpy(rng.uniform(0, 1, (1024, 6)).astype(
        np.float32)) for _ in range(2))
    kw = dict(kc=16, precision="f32")
    od, oi, _ = ex.extract_topk(q, d0, n_real=1024, id_base=0, **kw)
    lines = []
    rec = sweep.sweep_splits([
        sweep.SplitCase("fresh", q, d0, None, None,
                        {**kw, "n_real": 1024, "id_base": 0}),
        sweep.SplitCase("carried", q, d1, od, oi,
                        {**kw, "n_real": 1000, "id_base": 1024}, 3)],
        gate=True, reps=1, emit=lines.append)
    assert [ln["case"] for ln in lines] == ["fresh", "carried"]
    assert sorted(lines[0]["ms_by_splits"]) == [1, 2, 3, 4]
    assert rec["heuristic"] == {"splits": 1} and rec["changed"] == []
    assert rec["variant"]["splits"] in (1, 2, 3, 4)
    assert rec["measured_ms"] <= rec["heuristic_ms"]
    assert rec["cases"] == {"fresh": 1, "carried": 3}


def test_g_sweep_holds_every_g_against_the_heuristic():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.uniform(0, 1, (20, 5)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0, 1, (5 * 128, 5)).astype(np.float32))
    ids = torch.arange(640, dtype=torch.int32)
    ids[600:] = -1
    lines = []
    rec = sweep.sweep_groups("g", q, d, ids, reps=1, emit=lines.append)
    assert sorted(lines[0]["kernel_ms_by_group"]) == [1, 2, 3, 4, 5]
    assert rec["heuristic"] == {"group": 5} and rec["changed"] == []


def test_heuristic_rung_reads_no_cache(tmp_path, monkeypatch):
    """oom x 4 at single.extract_solve lands on the heuristic rung, where
    the tune cache is suppressed: a present cache sees no lookup, and the
    bytes are golden's."""
    inp, flags = _smoke_input("extract")
    c = cache.VariantCache()
    for kernel in ("extract_topk", "fused_topk"):
        c.put(kernel, "cpu", {"splits": 2},
              **_point(qb=32, b=512, a=8, kc=24))
    monkeypatch.setenv("DMLP_TPU_TUNE_CACHE",
                       c.save(str(tmp_path / "t.json")))
    stats.reset()
    inject.install(inject.FaultSchedule.from_dict(
        {"schema": 1, "seed": 0, "faults": [
            {"site": "single.extract_solve", "kind": "oom", "times": 4}]}))
    try:
        eng = single.SingleChipEngine(_cfg(flags))
        text = format_results(eng.run(inp))
    finally:
        inject.uninstall()
        stats.reset()
    assert eng.last_degrade_rung == "heuristic"
    assert cache.STATS == {"lookups": 0, "hits": 0}
    assert text == format_results(knn_golden_fast(inp))
    # The same solve without faults reads the cache.
    single.SingleChipEngine(_cfg(flags)).run(inp)
    assert cache.STATS["hits"] > 0


def test_cli_with_a_cache_prints_the_same_bytes(tmp_path, monkeypatch):
    inp, _ = _smoke_input("extract")
    from dmlp_tpu_torch.io.grammar import format_input
    text = format_input(inp)
    argv = ["--device", "cpu", "--pallas", "--select", "extract",
            "--data-block", "512"]

    def run():
        out = io.StringIO()
        assert cli.main(argv, stdin=io.StringIO(text), stdout=out,
                        stderr=io.StringIO()) == 0
        return out.getvalue()

    want = run()
    _write(tmp_path, monkeypatch, [
        ("fused_topk", {"splits": 2}, _point(qb=32, b=512, a=8, kc=24))])
    assert run() == want
    assert cache.STATS["hits"] == 2
