"""``obs.hlo``: the record of the collectives a solve issued, against
``obs.comms``' analytic models — the port's analog of ``tests/test_hlo.py``.

Three layers: (1) the byte convention per kind and the record's
normalisation, fingerprint, totals, traffic records and reconcile markers,
on hand-built op lists with hand-computed bytes (the analog of the
reference's ``TestParsing``); (2) the live engines as gloo ranks on the CPU
(one spawn of 8 ranks at (4, 2) and (2, 4), one of a single rank at (1, 1);
every process group with a 60 s timeout, every subprocess waited on with a
deadline): the sharded engine's record equal to its ``last_comms`` kind
for kind, the ring's R - 1 hops per rank counted (the analog of the
reference's trip-count test, which fails there), the auto engine's record
non-empty with its data-axis all-gather bytes equal to
``engine_comms("allgather", ...)`` of its plan, ``comms_from_hlo``, the
CPU memory marker, a 1 x 1 mesh's empty record, and no dispatch mode
active in a solve without a recording; (3) ``--hlo-report`` round trips
through the CLI for the sharded, ring and auto modes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu_torch.obs import comms as obs_comms  # noqa: E402
from dmlp_tpu_torch.obs import hlo as obs_hlo  # noqa: E402
from dmlp_tpu_torch.obs.comms import CollectiveTraffic  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _op(kind, operand, g, rank_bytes, axis="data", group="1",
        op=None, dtype="int32"):
    return {"kind": kind, "op": op or f"c10d.{kind}", "axis": axis,
            "group": group, "group_size": g, "operand_bytes": operand,
            "dtype": dtype, "bytes_moved": rank_bytes}


# ---------------------------------------------------------------------------
# the byte convention and the record, by hand
# ---------------------------------------------------------------------------

class TestConvention:
    def test_all_gather(self):
        # (g - 1) x the operand per rank; 4 ranks of 2 groups of 4
        assert obs_hlo.bytes_moved("all-gather", 128, 4) == 384
        assert 8 * obs_hlo.bytes_moved("all-gather", 128, 4) == 3072

    def test_all_reduce(self):
        assert obs_hlo.bytes_moved("all-reduce", 64, 4) \
            == round(2 * 3 * 64 / 4) == 96

    def test_reduce_scatter_and_all_to_all(self):
        for kind in ("reduce-scatter", "all-to-all"):
            assert obs_hlo.bytes_moved(kind, 128, 8) \
                == round(7 * 128 / 8) == 112

    def test_collective_permute(self):
        assert obs_hlo.bytes_moved("collective-permute", 256, 4) == 256

    def test_rooted_kinds(self):
        assert obs_hlo.bytes_moved("broadcast", 100, 4, root=True) == 300
        assert obs_hlo.bytes_moved("broadcast", 100, 4, root=False) == 0
        # the root's operand holds 4 parts of 40 B: it sends 3 of them
        assert obs_hlo.bytes_moved("scatter", 160, 4, root=True) == 120
        assert obs_hlo.bytes_moved("scatter", 160, 4, root=False) == 0
        assert obs_hlo.bytes_moved("gather", 40, 4, root=False) == 40
        assert obs_hlo.bytes_moved("gather", 40, 4, root=True) == 0


class TestRecord:
    def _ring_ranks(self):
        """A (4, 2) mesh's ring merge: every rank sends 3 hops of 96 B on
        its data group ("1" or "2")."""
        return [[_op("collective-permute", 96, 4, 96,
                     group=str(1 + r % 2), op="c10d.send.default")] * 3
                for r in range(8)]

    def test_normalise_folds_ranks_groups_and_senders(self):
        coll = obs_hlo.normalise(self._ring_ranks())
        assert len(coll) == 1
        ent = coll[0]
        assert (ent["count"], ent["ranks"], ent["senders"],
                ent["n_groups"]) == (24, 8, 8, 2)
        assert ent["bytes_moved"] == 24 * 96

    def test_fingerprint_ignores_rank_interleaving(self):
        per_rank = [[_op("all-gather", 10, 2, 10),
                     _op("broadcast", 4, 2, 4, axis="world", group="0")],
                    [_op("broadcast", 4, 2, 0, axis="world", group="0"),
                     _op("all-gather", 10, 2, 10)]]
        a = obs_hlo.build_report(per_rank, [None, None])
        b = obs_hlo.build_report([list(reversed(r)) for r in per_rank],
                                 [None, None])
        assert a.fingerprint == b.fingerprint
        assert len(a.fingerprint) == 16
        assert a.schema == obs_hlo.SCHEMA_VERSION == 1

    def test_totals_and_dispatch_multiplicity(self):
        coll = obs_hlo.normalise(self._ring_ranks())
        tot = obs_hlo.collective_totals(coll, dispatch_count=5)
        assert tot["collective-permute"] == {"ops": 1, "count": 120,
                                             "bytes_moved": 24 * 96 * 5}

    def test_traffic_records_reproduce_the_bytes(self):
        """One gspmd_* record per (kind, axis) whose bytes_total is the
        record's: the ring's 8 senders as 4 per group over 2 groups; the
        root's scatter as one sender."""
        per_rank = self._ring_ranks()
        per_rank[0] = per_rank[0] + [_op("scatter", 400, 8, 350,
                                         axis="world", group="0")]
        for r in range(1, 8):
            per_rank[r] = per_rank[r] + [_op("scatter", 400, 8, 0,
                                             axis="world", group="0")]
        rep = obs_hlo.build_report(per_rank, [None] * 8)
        got = {t.collective: t for t in obs_hlo.traffic_from_report(rep)}
        cp = got["gspmd_collective-permute"]
        assert (cp.axis, cp.axis_size, cp.n_groups, cp.senders) == \
            ("data", 4, 2, 4)
        assert cp.bytes_out_per_device == 3 * 96
        assert cp.bytes_total == 24 * 96
        sc = got["gspmd_scatter"]
        assert (sc.bytes_total, sc.senders) == (350, 1)

    def test_memory_marker_on_the_cpu_and_peak_on_the_card(self):
        rep = obs_hlo.build_report([[]], [None])
        assert "hlo_memory_unavailable" in rep.memory
        rec = obs_hlo.reconcile_memory([(rep, 1, "s")], {"model_bytes": 9})
        assert "hlo_memory_unavailable" in rec
        rep = obs_hlo.build_report([[], []], [1000, 1500])
        assert rep.memory["peak_bytes"] == 1500
        rec = obs_hlo.reconcile_memory([(rep, 1, "s")],
                                       {"model_bytes": 1500})
        assert rec["ratio"] == 1.0 and rec["within_tolerance"] is True
        rec = obs_hlo.reconcile_memory([(rep, 1, "s")], None)
        assert "mem_model_unavailable" in rec


class TestReconcile:
    def _rep(self):
        return obs_hlo.build_report(
            [[_op("all-gather", 128, 4, 384)] for _ in range(8)]
            + [[_op("broadcast", 8, 8, 0, axis="world", group="0")]],
            [None] * 9)

    def test_exact_match(self):
        model = CollectiveTraffic("all_gather_merge_topk", "data", 4,
                                  384, 384, n_groups=2)
        rec = obs_hlo.reconcile_comms([(self._rep(), 1, "s")], [model])
        ent = rec["kinds"]["all-gather"]
        assert ent["ratio"] == 1.0 and ent["within_tolerance"] is True
        assert ent["models"] == ["all_gather_merge_topk"]
        # the plan broadcast: no model names it, reported apart
        assert rec["unmodelled"] == {"broadcast": 0}
        assert rec["within_bounds"] is True

    def test_mismatch_and_model_only(self):
        model = CollectiveTraffic("all_gather_merge_topk", "data", 4,
                                  90, 90, n_groups=2)
        rec = obs_hlo.reconcile_comms([(self._rep(), 1, "s")], [model])
        assert rec["kinds"]["all-gather"]["within_tolerance"] is False
        assert rec["within_bounds"] is False
        ring = obs_comms.ring_topk_traffic(4, 8, 4, n_groups=2)
        rec = obs_hlo.reconcile_comms([(self._rep(), 1, "s")], [ring])
        assert rec["kinds"]["collective-permute"]["model_only"] is True
        assert rec["within_bounds"] is False

    def test_nothing_issued_nothing_modelled(self):
        rec = obs_hlo.reconcile_comms([], [])
        assert rec["no_collectives"] is True and rec["within_bounds"]

    def test_every_model_record_name_has_a_kind(self):
        """Every CollectiveTraffic name obs.comms builds maps onto a kind,
        so no model reconciles as "unknown"."""
        names = {t.collective for t in (
            obs_comms.scatter_comms((2, 2), 8, 3, [8], with_ids=True)
            + obs_comms.engine_comms("allgather", (2, 2), 8, 4)
            + obs_comms.engine_comms("ring", (2, 2), 8, 4)
            + obs_comms.gather_comms((2, 2), 8, 4)
            + [obs_comms.host_allgather_candidates_traffic(2, 1, 8, 4)])}
        assert names <= set(obs_hlo.TRAFFIC_COLLECTIVE_KINDS)

    def test_report_doc_and_flat_metrics(self):
        rep = self._rep()
        doc = obs_hlo.build_report_doc([(rep, 1, "cli.solve")],
                                       traffics=[], mem_block=None)
        assert doc["schema"] == 1
        assert doc["collective_bytes_total"] == 8 * 384
        assert doc["bytes_by_kind_axis"] == {"all-gather": {"data": 3072},
                                             "broadcast": {"world": 0}}
        flat = obs_hlo.flat_metrics(doc)
        assert flat["all_gather_bytes"] == 3072
        assert flat["executables_introspected"] == 1
        json.dumps(doc)
        empty = obs_hlo.build_report_doc([])
        assert "hlo_unavailable" in empty


# ---------------------------------------------------------------------------
# the live engines (gloo ranks)
# ---------------------------------------------------------------------------

INPUTS = {
    # The merged path: the streaming select on whole shards.
    "merged": generate_input_text(600, 33, 6, -5, 5, 1, 11, 4, seed=17),
    # The chunked extraction path with the router's outliers.
    "routed": generate_input_text(12000, 40, 5, 0.0, 50.0, 1, 900, 4,
                                  seed=23),
}
CONFIGS = {"merged": {"data_block": 16},
           "routed": {"select": "extract", "use_pallas": True,
                      "data_block": 2560}}

RANK_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.auto import AutoShardedEngine
from dmlp_tpu_torch.engine.sharded import RingEngine, ShardedEngine
from dmlp_tpu_torch.io.grammar import parse_input_text
from dmlp_tpu_torch.obs import hlo as obs_hlo
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh

work = sys.argv[1]
spec = json.load(open(work + "/spec.json"))
initialize(auto=True, device="cpu", timeout_s=60)
root = dist.get_rank() == 0
world = dist.get_world_size()
out = {}
modes = {"sharded": ShardedEngine, "ring": RingEngine,
         "auto": AutoShardedEngine}
for shape in spec["shapes"]:
    mesh = make_mesh(tuple(shape))
    for name, cfg in spec["configs"].items():
        inp = parse_input_text(open(f"{work}/{name}.in").read()) \
            if root else None
        for mode, cls in modes.items():
            eng = cls(EngineConfig(mode=mode, mesh_shape=tuple(shape),
                                   device="cpu", **cfg), mesh=mesh)
            # No recording: no dispatch mode is active in the solve.
            seen = []
            merge = eng._merge
            eng._merge = lambda top, k: (seen.append(
                (_get_current_dispatch_mode() is None,
                 obs_hlo.active() is None)), merge(top, k))[1]
            eng.run(inp)
            plain = {"modeless": list(seen), "from_hlo": None}
            if mode == "auto":
                plain["from_hlo"] = eng.comms_from_hlo() is None
            with obs_hlo.recording(eng) as rec:
                eng.run(inp)
            eng._merge = merge
            got = {"report": rec.report.to_dict(), "plain": plain,
                   "last_comms": [t.to_dict() for t in eng.last_comms],
                   "engine_record": eng._last_record is rec.report
                   if mode == "auto" else None}
            if mode == "auto":
                got["plan"] = eng.last_plan
                got["twin"] = [t.to_dict()
                               for t in eng.allgather_twin_comms()]
                got["from_hlo"] = eng.comms_from_hlo() is rec.report
                got["gspmd"] = [t.to_dict() for t in eng.last_comms]
            out[f"{shape[0]}x{shape[1]}/{name}/{mode}"] = got
if root:
    json.dump(out, open(f"{work}/out{world}.json", "w"))
shutdown()
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every (shape, input, mode)'s records: one spawn of 8 ranks for
    (4, 2) and (2, 4), one of a single rank for (1, 1)."""
    work = tmp_path_factory.mktemp("hlo")
    for name, text in INPUTS.items():
        (work / f"{name}.in").write_text(text)
    out = {}
    for world, shapes in ((8, [(4, 2), (2, 4)]), (1, [(1, 1)])):
        (work / "spec.json").write_text(json.dumps(
            {"shapes": shapes, "configs": CONFIGS}))
        spawn_ranks(work, RANK_SCRIPT, world, timeout=400)
        out.update(json.loads((work / f"out{world}.json").read_text()))
    return out


def _report(rec):
    d = dict(rec["report"])
    return obs_hlo.HloReport(**{k: d[k] for k in (
        "label", "fingerprint", "collectives", "totals", "memory",
        "cost")})


def _traffics(dicts):
    return [CollectiveTraffic(**{k: v for k, v in d.items()
                                 if k != "bytes_total"}) for d in dicts]


LIVE = [pytest.param(s, n, id=f"{s[0]}x{s[1]}-{n}")
        for s in ((4, 2), (2, 4)) for n in INPUTS]


@pytest.mark.parametrize("shape,name", LIVE)
@pytest.mark.parametrize("mode", ["sharded", "ring"])
def test_mesh_engines_reconcile_exactly(records, shape, name, mode):
    """The sharded and ring engines' records equal their ``last_comms``
    kind for kind (the root's scatters, the data-axis merge, row 0's
    gather): ratio 1 exactly, the plan broadcasts reported apart."""
    rec = records[f"{shape[0]}x{shape[1]}/{name}/{mode}"]
    rep = _report(rec)
    got = obs_hlo.reconcile_comms([(rep, 1, "solve")],
                                  _traffics(rec["last_comms"]))
    assert got["within_bounds"] is True
    merge = "all-gather" if mode == "sharded" else "collective-permute"
    assert set(got["kinds"]) == {merge, "scatter", "gather"}
    for ent in got["kinds"].values():
        assert ent["ratio"] == 1.0
    assert set(got["unmodelled"]) == {"broadcast"}
    assert "hlo_memory_unavailable" in rep.memory


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ring_counts_its_hops(records, shape):
    """Every rank of the ring sends R - 1 hops per merged segment over
    its data group (two segments on the routed input): the record counts
    each, and its bytes are the ring model's."""
    r, c = shape
    for name, segments in (("merged", 1), ("routed", 2)):
        rec = records[f"{r}x{c}/{name}/ring"]
        cp = [op for op in rec["report"]["collectives"]
              if op["kind"] == "collective-permute"]
        assert sum(op["count"] for op in cp) == r * c * (r - 1) * segments
        assert {op["axis"] for op in cp} == {"data"}
        assert {op["n_groups"] for op in cp} == {c}
        model = sum(t["bytes_total"] for t in rec["last_comms"]
                    if t["collective"] == "ring_allreduce_topk")
        assert sum(op["bytes_moved"] for op in cp) == model > 0


@pytest.mark.parametrize("shape,name", LIVE)
def test_auto_record_is_the_allgather_models(records, shape, name):
    """The auto engine's record is non-empty; its all-gather lies on the
    data axis and moves exactly ``engine_comms("allgather", ...)``'s
    bytes for its plan; the whole record reconciles with the all-gather
    engine's model of the plan; ``comms_from_hlo`` fills ``last_comms``
    with gspmd_* records of the record's bytes."""
    r, c = shape
    rec = records[f"{r}x{c}/{name}/auto"]
    rep = _report(rec)
    assert rep.totals and rec["engine_record"] and rec["from_hlo"]
    ag = [op for op in rep.collectives if op["kind"] == "all-gather"]
    assert {op["axis"] for op in ag} == {"data"}
    assert {op["op"] for op in ag} == {
        "_c10d_functional.all_gather_into_tensor.default"}
    plan = rec["plan"]
    want = sum(t.bytes_total for t in obs_comms.engine_comms(
        "allgather", shape, plan["qloc"], plan["k"]))
    assert sum(op["bytes_moved"] for op in ag) == want > 0
    got = obs_hlo.reconcile_comms([(rep, 1, "solve")],
                                  _traffics(rec["twin"]))
    assert got["within_bounds"] is True
    assert all(e["ratio"] == 1.0 for e in got["kinds"].values())
    gspmd = rec["gspmd"]
    assert gspmd and all(t["collective"].startswith("gspmd_")
                         for t in gspmd)
    assert sum(t["bytes_total"] for t in gspmd) == sum(
        a["bytes_moved"] for a in rep.totals.values())
    assert {t["axis"] for t in gspmd} <= {"data", "query", "world"}


@pytest.mark.parametrize("mode", ["sharded", "ring", "auto"])
def test_no_dispatch_mode_without_a_recording(records, mode):
    """A solve outside ``obs.hlo.recording`` runs with no dispatch mode
    active (checked inside the merge on every solve of rank 0), and the
    auto engine's ``comms_from_hlo`` is None after it."""
    for key, rec in records.items():
        if key.endswith("/" + mode):
            assert rec["plain"]["modeless"]
            assert all(a and b for a, b in rec["plain"]["modeless"])
            if mode == "auto":
                assert rec["plain"]["from_hlo"] is True


def test_one_by_one_mesh_records_no_collective(records):
    """A 1 x 1 mesh issues nothing: the record is empty and says so."""
    for name in INPUTS:
        for mode in ("sharded", "ring", "auto"):
            rec = records[f"1x1/{name}/{mode}"]
            rep = _report(rec)
            assert rep.collectives == [] and rep.totals == {}
            got = obs_hlo.reconcile_comms([(rep, 1, "solve")],
                                          _traffics(rec["last_comms"]))
            assert got["no_collectives"] is True
        assert records[f"1x1/{name}/auto"]["gspmd"] == []


# ---------------------------------------------------------------------------
# --hlo-report through the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sharded", "ring", "auto"])
def test_cli_hlo_report_round_trip(tmp_path, mode):
    """``python -m dmlp_tpu_torch --device cpu --mode MODE --mesh 2,2
    --hlo-report F`` (4 gloo ranks): stdout golden's, one ``kind="hlo"``
    RunRecord whose comms leg is within bounds (the auto engine's held
    against the all-gather model of its plan), the CPU memory marker and
    the flat metrics."""
    text = generate_input_text(3000, 20, 6, -10, 10, 1, 12, 4, seed=9)
    src = tmp_path / "in.txt"
    src.write_text(text)
    path = tmp_path / "HLO_r99.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    with open(src) as f:
        p = subprocess.run(
            [sys.executable, "-m", "dmlp_tpu_torch", "--device", "cpu",
             "--mode", mode, "--mesh", "2,2", "--hlo-report", str(path)],
            stdin=f, capture_output=True, text=True, cwd=ROOT, env=env,
            timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout == format_results(knn_golden(parse_input_text(text)))
    lines = path.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["kind"] == "hlo" and rec["round"] == 99
    assert rec["config"]["mode"] == mode and rec["config"]["mesh"] == [2, 2]
    doc = rec["comms"]
    assert doc["schema"] == 1 and len(doc["executables"]) == 1
    comms = doc["reconcile"]["comms_model"]
    assert comms["within_bounds"] is True
    merge = "collective-permute" if mode == "ring" else "all-gather"
    assert comms["kinds"][merge]["ratio"] == 1.0
    assert "hlo_memory_unavailable" in doc["reconcile"]["memory"]
    assert rec["metrics"]["collective_bytes_total"] \
        == doc["collective_bytes_total"] > 0
    assert doc["bytes_by_kind_axis"][merge] == {
        "data": comms["kinds"][merge]["hlo_bytes"]}
