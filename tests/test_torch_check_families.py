"""dmlp_tpu_torch.check — the checker's R1, R8, R9 and R10 families.

Five layers: (1) every fixture of the reference's ``TestR1Collectives``,
``TestDispatchCost``, ``TestR9AutoShard`` (``tests/test_check.py``),
``TestR10HloIntro`` and ``TestR903Constraints`` (``tests/test_hlo.py``),
translated into what the port writes (``torch.distributed`` groups,
DTensor placements, kernel names as strings): the reference's analyzer
runs its own fixture, read from those files, and the port's the
translation, and the two give the same rule ids; (2) caught/clean pairs
for R801-R803 in CUDA and in torch, which the reference has no fixture
for; (3) whole-tree tests on a copy of the port, each removing or
renaming one real thing and expecting its rule; (4) the cache over a
``.cu`` file and ``obs/comms.py``; (5) ``obs/hlo.py``'s reconcile table
against ``obs/comms.py`` and the port's annotations.
"""

import ast
import shutil
import textwrap
from pathlib import Path

import pytest

from dmlp_tpu.check import analyzer as ref_analyzer
from dmlp_tpu_torch.check.analyzer import (analyze_modules, analyze_paths,
                                           load_modules, package_root)
from dmlp_tpu_torch.check.cache import CheckCache
from dmlp_tpu_torch.check.facts import build_package_facts

ROOT = Path(__file__).resolve().parents[1]


def write(base, rel, source):
    p = Path(base) / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return str(p)


def rules_of(findings):
    return sorted(f.rule for f in findings)


def run_check(base, families, cache=None):
    return analyze_paths([str(base)], families, root=str(base), cache=cache)


# ---------------------------------------------------------------------------
# (1) the reference's fixtures, translated
# ---------------------------------------------------------------------------

MESH = ("dmlp_tpu_torch/parallel/mesh.py", """
DATA_AXIS = "data"
QUERY_AXIS = "query"
""")

#: reference (file, class.test) -> the port's translation: {relpath:
#: source} and the families the reference test runs
PORT_FIXTURES = {
    # -- TestR1Collectives ----------------------------------------------------
    ("test_check.py", "TestR1Collectives.test_r101_undeclared_axis_caught"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/ops/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group("bogus"))
        """)]),
    ("test_check.py",
     "TestR1Collectives.test_r101_declared_axis_clean_incl_constant"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/ops/x.py", """
            import torch.distributed as dist
            from dmlp_tpu_torch.parallel.mesh import DATA_AXIS
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group(DATA_AXIS))
                dist.barrier(group=mesh["query"].get_group())
        """)]),
    ("test_check.py",
     "TestR1Collectives.test_r102_axis_not_in_shard_map_specs"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh

            def build():
                mesh = init_device_mesh("cpu", (2,),
                                        mesh_dim_names=("data",))
                def local(a):
                    dist.all_reduce(a, group=mesh.get_group("query"))  # check: no-traffic
                return local
        """)]),
    ("test_check.py", "TestR1Collectives.test_r102_spec_axis_clean"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh

            def build():
                mesh = init_device_mesh("cpu", (2,),
                                        mesh_dim_names=("data",))
                def local(a):
                    dist.all_reduce(a, group=mesh.get_group("data"))  # check: no-traffic
                return local
        """)]),
    ("test_check.py",
     "TestR1Collectives.test_r103_unannotated_traffic_collective"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/train/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group("data"))
        """)]),
    ("test_check.py",
     "TestR1Collectives.test_r103_annotated_with_real_model_clean"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/obs/comms.py", """
            def psum_traffic(nbytes, axis_size):
                return nbytes
        """), ("dmlp_tpu_torch/train/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                # check: comms-model=psum_traffic
                dist.all_reduce(x, group=mesh.get_group("data"))
        """)]),
    ("test_check.py",
     "TestR1Collectives.test_r104_annotation_names_missing_model"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/obs/comms.py",
                        "def real_model():\n    pass\n"),
                 ("dmlp_tpu_torch/train/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                # check: comms-model=renamed_away_traffic
                dist.all_reduce(x, group=mesh.get_group("data"))
        """)]),
    ("test_check.py",
     "TestR1Collectives.test_axis_helper_call_site_checked"): (
        ["R1"], [MESH, ("dmlp_tpu_torch/parallel/helpers.py", """
            import torch.distributed as dist
            def merge(local, k, group):
                parts = [local, local]
                # check: comms-model=m
                dist.all_gather(parts, local, group=group)
                return parts
        """), ("dmlp_tpu_torch/obs/comms.py", "def m():\n    pass\n"),
                 ("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.parallel.helpers import merge
            def f(local, k, mesh):
                return merge(local, k, mesh.get_group("not_an_axis"))
        """)]),
    # -- TestDispatchCost -----------------------------------------------------
    ("test_check.py", "TestDispatchCost.test_r105_dispatch_without_probe"): (
        ["R1"], [("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.obs import counters as obs_counters
            from dmlp_tpu_torch.ops.fused import fused_topk

            def drive(q, d):
                obs_counters.record_dispatch("fused_topk", {"qb": 8})
                return fused_topk(q, d, n_real=4, kc=8)
        """)]),
    ("test_check.py",
     "TestDispatchCost.test_r105_resolver_bound_kernel_var_covered"): (
        ["R1"], [("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.ops import fused

            def drive(q, d):
                kern, impl = fused.resolve_topk_kernel(8, 8, 8, 8)
                return kern(q, d, n_real=4, kc=8)
        """)]),
    ("test_check.py",
     "TestDispatchCost.test_r105_probe_in_function_clean"): (
        ["R1"], [("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.engine.single import MeasuredIters
            from dmlp_tpu_torch.ops.fused import fused_topk

            def drive(eng, q, d):
                mi = MeasuredIters(eng, "fused", (1, 2, 3, 4))
                od, oi, it = fused_topk(q, d, n_real=4, kc=8)
                mi.add(it)
                mi.done()
                return od
        """)]),
    ("test_check.py",
     "TestDispatchCost.test_r105_queue_iters_protocol_clean"): (
        ["R1"], [("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.ops import fused

            def drive(self, q, d):
                kern, impl = fused.resolve_topk_kernel(8, 8, 8, 8)
                od, oi, it = kern(q, d, n_real=4, kc=8)
                self._queue_iters("s", "extract", it, 8, 8, 8, 8,
                                  impl=impl)
                return od
        """)]),
    ("test_check.py", "TestDispatchCost.test_r106_unmodeled_ops_kernel"): (
        ["R1"], [("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.engine.single import MeasuredIters
            from dmlp_tpu_torch.obs import counters as obs_counters
            from dmlp_tpu_torch.ops.fused import fused_topk

            def drive(eng, q, d):
                mi = MeasuredIters(eng, "fused", (1, 2, 3, 4))
                obs_counters.record_dispatch("hyper_kernel", {"qb": 8})
                od, oi, it = fused_topk(q, d, n_real=4, kc=8)
                mi.add(it)
                mi.done()
                return od
        """)]),
    ("test_check.py", "TestDispatchCost.test_r105_allow_directive"): (
        ["R1"], [("dmlp_tpu_torch/engine/x.py", """
            from dmlp_tpu_torch.ops.fused import fused_topk

            def drive(q, d):
                # check: allow-collective
                return fused_topk(q, d, n_real=4, kc=8)
        """)]),
    ("test_check.py", "TestDispatchCost.test_r105_outside_engine_ignored"): (
        ["R1"], [("dmlp_tpu_torch/bench/x.py", """
            from dmlp_tpu_torch.obs import counters as obs_counters
            from dmlp_tpu_torch.ops.fused import fused_topk

            def drive(q, d):
                obs_counters.record_dispatch("fused_topk", {"qb": 8})
                return fused_topk(q, d, n_real=4, kc=8)
        """)]),
    # -- TestR9AutoShard ------------------------------------------------------
    ("test_check.py",
     "TestR9AutoShard.test_r901_undeclared_pspec_axis_caught"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            def mesh():
                return init_device_mesh("cpu", (2, 1),
                                        mesh_dim_names=("dataa", "query"))
        """)]),
    ("test_check.py",
     "TestR9AutoShard.test_r901_declared_axes_and_none_entries_clean"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                                  distribute_tensor)
            from dmlp_tpu_torch.parallel.mesh import DATA_AXIS, QUERY_AXIS
            def place(x):
                mesh = init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=(DATA_AXIS, QUERY_AXIS))
                return (distribute_tensor(x, mesh, [Shard(0), Replicate()]),
                        DTensor.from_local(x, mesh, [Replicate(), Shard(1)]),
                        DTensor.from_local(x, mesh[DATA_AXIS], [Shard(0)]))
        """)]),
    ("test_check.py",
     "TestR9AutoShard.test_r901_allow_directive_respected"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            def mesh():
                # check: allow-auto-shard=R901 — doc example axis
                return init_device_mesh("cpu", (2,), mesh_dim_names=("stage",))
        """)]),
    ("test_check.py",
     "TestR9AutoShard.test_r902_unpinned_jit_in_auto_engine_caught"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/auto.py", """
            from torch.distributed.tensor import DTensor
            def place(x, mesh):
                return DTensor.from_local(x, mesh)
        """)]),
    ("test_check.py",
     "TestR9AutoShard.test_r902_pinned_jit_clean_and_other_files_exempt"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/auto.py", """
            from torch.distributed.tensor import DTensor
            def place(x, mesh, placements):
                return DTensor.from_local(x, mesh, placements)
        """), ("dmlp_tpu_torch/engine/other.py", """
            from torch.distributed.tensor import DTensor
            def place(x, mesh):
                return DTensor.from_local(x, mesh)
        """)]),
    # -- TestR10HloIntro ------------------------------------------------------
    ("test_hlo.py", "TestR10HloIntro.test_dangling_annotation_caught"): (
        ["R10"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            import torch.distributed as dist
            from dmlp_tpu_torch.parallel.mesh import DATA_AXIS
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group(DATA_AXIS))  # check: comms-model=renamed_away_traffic
        """)]),
    ("test_hlo.py", "TestR10HloIntro.test_mapped_annotation_clean"): (
        ["R10"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            import torch.distributed as dist
            from dmlp_tpu_torch.parallel.mesh import DATA_AXIS
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group(DATA_AXIS))  # check: comms-model=psum_traffic
        """)]),
    ("test_hlo.py", "TestR10HloIntro.test_allow_directive_waives"): (
        ["R10"], [("dmlp_tpu_torch/engine/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group("data"))  # check: comms-model=unmapped_traffic allow-hlo-model
        """)]),
    ("test_hlo.py", "TestR10HloIntro.test_out_of_scope_dirs_skipped"): (
        ["R10"], [("dmlp_tpu_torch/obs/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group("data"))  # check: comms-model=unmapped_traffic
        """)]),
    ("test_hlo.py",
     "TestR10HloIntro.test_fixture_table_overrides_installed"): (
        ["R10"], [("dmlp_tpu_torch/obs/hlo.py", """
            MODEL_COLLECTIVE_KINDS = {"custom_traffic": "all-gather"}
        """), ("dmlp_tpu_torch/engine/x.py", """
            import torch.distributed as dist
            def f(x, mesh):
                dist.all_reduce(x, group=mesh.get_group("data"))  # check: comms-model=psum_traffic
            def g(x, mesh):
                dist.all_reduce(x, group=mesh.get_group("data"))  # check: comms-model=custom_traffic
        """)]),
    # -- TestR903Constraints --------------------------------------------------
    ("test_hlo.py",
     "TestR903Constraints.test_variable_held_undeclared_axis_caught"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import Shard
            def f(x):
                mesh = init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "typo_axis"))
                pl = [Shard(0)]
                return x.redistribute(mesh, pl)
        """)]),
    ("test_hlo.py",
     "TestR903Constraints.test_variable_held_declared_axis_clean"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import Replicate, Shard
            from dmlp_tpu_torch.parallel.mesh import DATA_AXIS, QUERY_AXIS
            def f(x):
                mesh = init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=(DATA_AXIS, QUERY_AXIS))
                pl = [Shard(0), Replicate()]
                return x.redistribute(mesh, pl)
        """)]),
    ("test_hlo.py",
     "TestR903Constraints.test_opaque_binding_skipped_not_guessed"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            def f(x, placement_factory):
                mesh = init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "query"))
                pl = placement_factory()
                return x.redistribute(mesh, pl)
        """)]),
    ("test_hlo.py", "TestR903Constraints.test_scoped_allow_waives"): (
        ["R9"], [MESH, ("dmlp_tpu_torch/engine/x.py", """
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import Shard
            def f(x):
                mesh = init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "replica_local"))
                pl = [Shard(0)]
                # check: allow-auto-shard=R903
                return x.redistribute(mesh, pl)
        """)]),
}


def _reference_fixture(test_file: str, qualname: str):
    """({relpath: source}, families) of one fixture test of the
    reference, read from its test file (module-level string constants
    resolved)."""
    tree = ast.parse((ROOT / "tests" / test_file).read_text())
    consts = {s.targets[0].id: s.value.value for s in tree.body
              if isinstance(s, ast.Assign)
              and isinstance(s.value, ast.Constant)
              and isinstance(s.value.value, str)}
    cls_name, fn_name = qualname.split(".")
    cls = next(c for c in tree.body
               if isinstance(c, ast.ClassDef) and c.name == cls_name)
    fn = next(f for f in cls.body
              if isinstance(f, ast.FunctionDef) and f.name == fn_name)
    files, families = {}, None
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Name):
            continue
        if node.func.id in ("write", "_write"):
            src = node.args[2]
            files[node.args[1].value] = src.value \
                if isinstance(src, ast.Constant) else consts[src.id]
        elif node.func.id in ("run_check", "_rules"):
            families = [e.value for e in node.args[1].elts]
    return files, families


def test_every_reference_fixture_is_translated():
    """The translated set is exactly the reference's fixture tests of
    these classes (the two that read the installed package are tested
    below)."""
    want = set()
    for test_file, classes in (
            ("test_check.py", ("TestR1Collectives", "TestDispatchCost",
                               "TestR9AutoShard")),
            ("test_hlo.py", ("TestR10HloIntro", "TestR903Constraints"))):
        tree = ast.parse((ROOT / "tests" / test_file).read_text())
        for cls in tree.body:
            if isinstance(cls, ast.ClassDef) and cls.name in classes:
                want |= {(test_file, f"{cls.name}.{fn.name}")
                         for fn in cls.body
                         if isinstance(fn, ast.FunctionDef)}
    skipped = {("test_check.py",
                "TestDispatchCost.test_r106_registered_kernels_clean"),
               ("test_hlo.py", "TestR10HloIntro."
                "test_real_package_table_covers_every_annotation")}
    assert set(PORT_FIXTURES) == want - skipped
    assert len(PORT_FIXTURES) == 29


@pytest.mark.parametrize("ref", sorted(PORT_FIXTURES),
                         ids=[n for _f, n in sorted(PORT_FIXTURES)])
def test_port_rule_ids_equal_the_reference_fixtures(ref, tmp_path):
    families, files = PORT_FIXTURES[ref]
    ref_files, ref_families = _reference_fixture(*ref)
    assert ref_families == families
    for rel, src in ref_files.items():
        write(tmp_path / "ref", rel, src)
    want = ref_analyzer.analyze_paths([str(tmp_path / "ref")], families,
                                      root=str(tmp_path / "ref"))
    for rel, src in files:
        write(tmp_path / "port", rel, src)
    got = run_check(tmp_path / "port", families)
    assert sorted(set(rules_of(got))) == sorted(set(rules_of(want)))
    # where the reference names the offending value, the port does too
    for f in want:
        for word in ("bogus", "renamed_away_traffic", "psum_traffic",
                     "hyper_kernel", "dataa", "typo_axis"):
            if word in f.message:
                assert any(word in g.message for g in got), (word, got)
        if f.path.endswith("engine/x.py"):
            assert any(g.path.endswith("engine/x.py") for g in got)


@pytest.fixture(scope="module")
def port_tree():
    """The port's modules (Python and CUDA), parsed once, with their
    merged facts."""
    mods, parse_findings = load_modules([package_root()])
    assert parse_findings == []
    return mods, build_package_facts(mods)


def test_r106_registered_kernels_are_the_model_table(port_tree):
    """The parse of the real ``_MODELS`` and ``LAUNCHES``: every kernel
    the wrappers count has a model (an empty parse would make R106 fire
    on every record or none)."""
    _mods, facts = port_tree
    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.obs import kernel_cost
    assert facts.modeled_kernels == set(kernel_cost._MODELS)
    assert facts.launch_names == set(kernels.LAUNCHES)
    assert {"fused_topk", "extract_topk", "extract_merge",
            "fused_dist_segmin"} <= facts.modeled_kernels
    assert facts.eps_models == {"lowp_eps", "staging_eps"}


# ---------------------------------------------------------------------------
# (2) R8 in CUDA and in torch
# ---------------------------------------------------------------------------

CU = "dmlp_tpu_torch/kernels/k.cu"
OPS = "dmlp_tpu_torch/ops/extract.py"
FINALIZE = ("dmlp_tpu_torch/engine/finalize.py", """
def lowp_eps(precision, qn, dn_max):
    return 0.0
def staging_eps(last, qn, dn_max, dtype):
    return 0.0
""")

R8_CAUGHT = {
    "cu_half_plus_equals": ("R801", CU, """
        #include <cuda_fp16.h>
        __global__ void k(const __half* a, __half* o, int n) {
          __half acc = o[0];
          for (int i = 0; i < n; ++i) acc += a[i];
          o[0] = acc;
        }
    """),
    "cu_hfma_intrinsic": ("R801", CU, """
        #include <cuda_bf16.h>
        __global__ void k(const __nv_bfloat16* a, __nv_bfloat16* o) {
          o[0] = __hfma(a[0], a[1], o[0]);
        }
    """),
    "cu_wmma_half_accumulator": ("R801", CU, """
        #include <mma.h>
        using namespace nvcuda;
        __global__ void k() {
          wmma::fragment<wmma::accumulator, 16, 16, 16, half> c;
        }
    """),
    "cu_mma_f16_accumulator": ("R801", CU, """
        __device__ void k(unsigned* d, const unsigned* a) {
          asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 "
                       "{%0,%1}, {%2,%3,%4,%5}, {%6,%7}, {%8,%9};" : : );
        }
    """),
    "cu_cast_unannotated": ("R802", CU, """
        #include <cuda_bf16.h>
        __device__ float round_bf16(float x) {
          return __bfloat162float(__float2bfloat16_rn(x));
        }
    """),
    "cu_cast_wrapper_call_unannotated": ("R802", CU, """
        #include <cuda_bf16.h>
        __device__ float round_bf16(float x) {
          return __bfloat162float(__float2bfloat16_rn(x));  // check: lowp-eps=lowp_eps
        }
        __global__ void k(float* q) { q[0] = round_bf16(q[0]); }
    """),
    "cu_eps_names_no_bound": ("R803", CU, """
        #include <cuda_fp16.h>
        __device__ __half h(float x) {
          return __float2half_rn(x);  // check: lowp-eps=made_up_eps
        }
    """),
    "py_product_on_low_operands": ("R801", OPS, """
        import torch
        def cross(q, d):
            qb = q.to(torch.bfloat16)  # check: lowp-eps=lowp_eps
            db = d.bfloat16()  # check: lowp-eps=lowp_eps
            return torch.mm(qb, db.T)
    """),
    "py_matmul_operator_on_a_cast": ("R801", OPS, """
        import torch
        def cross(q, d):
            return q.half() @ d.T  # check: lowp-eps=lowp_eps
    """),
    "py_tf32_switch_anywhere": ("R801", "dmlp_tpu_torch/engine/x.py", """
        import torch
        def setup():
            torch.backends.cuda.matmul.allow_tf32 = True
    """),
    "py_matmul_precision_high": ("R801", "dmlp_tpu_torch/serve/x.py", """
        import torch
        def setup():
            torch.set_float32_matmul_precision("high")
    """),
    "py_cast_unannotated": ("R802", OPS, """
        import torch
        def round_bf16(x):
            return x.to(torch.bfloat16).float()
    """),
    "py_half_unannotated": ("R802", "dmlp_tpu_torch/ops/distance.py", """
        def round_f16(x):
            return x.half().float()
    """),
    "py_eps_names_no_bound": ("R803", OPS, """
        import torch
        def round_bf16(x):
            return x.to(torch.bfloat16).float()  # check: lowp-eps=bf16_eps
    """),
}

R8_CLEAN = {
    "cu_float_accumulator_of_bf16_products": (CU, """
        #include <cuda_bf16.h>
        __global__ void k(const __nv_bfloat16* a, float* o, int n) {
          float acc = 0.f;  // the __half in this comment is not code
          for (int i = 0; i < n; ++i)
            acc += __bfloat162float(a[i]) * __bfloat162float(a[i]);
          o[0] = acc;
        }
    """),
    "cu_f32_accumulators": (CU, """
        #include <mma.h>
        using namespace nvcuda;
        __global__ void k() {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
          asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                       "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};");
        }
    """),
    "cu_casts_annotated": (CU, """
        #include <cuda_bf16.h>
        // The one rounding of the bf16 pass.
        __device__ float round_bf16(float x) {
          return __bfloat162float(__float2bfloat16_rn(x));  // check: lowp-eps=lowp_eps
        }
        __global__ void k(float* q, float* d) {
          // check: lowp-eps=lowp_eps
          q[0] = round_bf16(q[0]);
          d[0] = round_bf16(d[0]);  // check: lowp-eps=staging_eps
        }
    """),
    "cu_allow_lowprec": (CU, """
        #include <cuda_fp16.h>
        __global__ void k(__half* o) {
          o[0] = __hadd(o[0], o[1]);  // check: allow-lowprec
        }
    """),
    "py_promoted_operands": (OPS, """
        import torch
        def cross(q, d):
            qb = q.to(torch.bfloat16).float()  # check: lowp-eps=lowp_eps
            # check: lowp-eps=lowp_eps
            q2, d2 = q.to(torch.bfloat16).float(), d.to(torch.bfloat16).float()
            return qb @ d.T, torch.matmul(q2, d2.T)
    """),
    "py_out_dtype_f32": (OPS, """
        import torch
        def cross(q, d):
            qb = q.to(torch.bfloat16)  # check: lowp-eps=lowp_eps
            return torch.mm(qb, qb.T, out_dtype=torch.float32)
    """),
    "py_tf32_read_or_off": ("dmlp_tpu_torch/ops/distance.py", """
        import torch
        def ieee(t):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
            return not torch.backends.cuda.matmul.allow_tf32
    """),
    "py_cast_outside_scope": ("dmlp_tpu_torch/train/x.py", """
        import torch
        def step(w):
            return w.to(torch.bfloat16) @ w.to(torch.bfloat16).T
    """),
    "py_int_casts_are_not_lowp": (OPS, """
        import torch
        def labels(x):
            return x.to(torch.int32), x.to(torch.int8)
    """),
}


@pytest.mark.parametrize("case", sorted(R8_CAUGHT))
def test_r8_fixture_caught(case, tmp_path):
    rule, rel, src = R8_CAUGHT[case]
    write(tmp_path, *FINALIZE)
    write(tmp_path, rel, src)
    fs = run_check(tmp_path, ["R8"])
    assert rules_of(fs) and set(rules_of(fs)) == {rule}, fs


@pytest.mark.parametrize("case", sorted(R8_CLEAN))
def test_r8_fixture_clean(case, tmp_path):
    rel, src = R8_CLEAN[case]
    write(tmp_path, *FINALIZE)
    write(tmp_path, rel, src)
    assert run_check(tmp_path, ["R8"]) == []


def test_r803_falls_back_to_the_ports_finalize(tmp_path):
    """A fixture tree without engine/finalize.py reads the port's own
    bounds: lowp_eps is known, a made-up name is not."""
    write(tmp_path, OPS, """
        import torch
        def a(x):
            return x.to(torch.bfloat16).float()  # check: lowp-eps=lowp_eps
        def b(x):
            return x.to(torch.bfloat16).float()  # check: lowp-eps=nope_eps
    """)
    fs = run_check(tmp_path, ["R8"])
    assert [(f.rule, f.scope) for f in fs] == [("R803", "b")]


# ---------------------------------------------------------------------------
# (3) the whole port, one real thing removed or renamed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_cache(tmp_path_factory):
    """One cache for the whole-tree runs: unchanged files load their
    facts from it, so each run re-parses only what it analyzes."""
    return str(tmp_path_factory.mktemp("check_cache"))


def _port_copy(base: Path) -> Path:
    shutil.copytree(package_root(), base / "dmlp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return base


def _edit(base: Path, rel: str, old: str, new: str) -> None:
    p = base / "dmlp_tpu_torch" / rel
    s = p.read_text()
    assert s.count(old) >= 1, (rel, old)
    p.write_text(s.replace(old, new))


WHOLE_TREE = {
    "comms_model_removed": (
        ["R1"], "parallel/collectives.py",
        "  # check: comms-model=allgather_topk_traffic", "",
        {("R103", "dmlp_tpu_torch/parallel/collectives.py")}),
    "comms_model_renamed": (
        ["R1", "R10"], "obs/comms.py",
        "def allgather_topk_traffic(", "def allgather_merge_traffic(",
        {("R104", "dmlp_tpu_torch/parallel/collectives.py"),
         ("R1001", "dmlp_tpu_torch/parallel/collectives.py")}),
    "group_on_undeclared_axis": (
        ["R1"], "engine/sharded.py",
        "self.mesh.get_group(DATA_AXIS)", 'self.mesh.get_group("rows")',
        {("R101", "dmlp_tpu_torch/engine/sharded.py"),
         ("R001", None)}),
    "kernel_model_removed": (
        ["R1"], "obs/kernel_cost.py",
        '    "extract_merge": lambda s:', '    "merge_x": lambda s:',
        {("R106", "dmlp_tpu_torch/ops/extract.py"),
         ("R106", "dmlp_tpu_torch/kernels/__init__.py")}),
    "lowp_eps_stripped_from_the_kernel": (
        ["R8"], "kernels/extract_topk.cu",
        "// check: lowp-eps=lowp_eps", "",
        {("R802", "dmlp_tpu_torch/kernels/extract_topk.cu")}),
    "auto_engine_placements_dropped": (
        ["R9"], "engine/auto.py",
        "DTensor.from_local(t, self.mesh, placements, run_check=False)",
        "DTensor.from_local(t, self.mesh, run_check=False)",
        {("R902", "dmlp_tpu_torch/engine/auto.py")}),
}


@pytest.mark.parametrize("case", sorted(WHOLE_TREE))
def test_whole_port_fires_on_one_real_removal(case, tmp_path, port_cache):
    families, rel, old, new, want = WHOLE_TREE[case]
    base = _port_copy(tmp_path)
    cache = CheckCache(directory=port_cache, enabled=True)
    assert run_check(base, families, cache=cache) == []
    _edit(base, rel, old, new)
    cache = CheckCache(directory=port_cache, enabled=True)
    fs = run_check(base, families + (["R0"] if case.startswith("group")
                                     else []), cache=cache)
    got = {(f.rule, f.path) for f in fs}
    for rule, path in want:
        if path is None:             # the now-unused constant (R0)
            assert any(r == rule for r, _p in got), fs
        else:
            assert (rule, path) in got, fs
    assert {r for r, _p in got} == {r for r, _p in want}, fs


@pytest.mark.parametrize("family", ["R1", "R8", "R9", "R10"])
def test_each_family_runs_clean_over_the_port(family, port_tree):
    mods, facts = port_tree
    assert any(m.relpath.endswith(".cu") for m in mods)
    assert analyze_modules(mods, [family], facts) == []


# ---------------------------------------------------------------------------
# (4) the cache over CUDA sources and the comms models
# ---------------------------------------------------------------------------

KERNEL = """
#include <cuda_bf16.h>
__device__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));  // check: lowp-eps=lowp_eps
}
"""


def test_cache_cu_edit_invalidates_only_the_cu_file(tmp_path):
    write(tmp_path, *FINALIZE)
    write(tmp_path, "dmlp_tpu_torch/kernels/k.cu", KERNEL)
    write(tmp_path, OPS, R8_CLEAN["py_out_dtype_f32"][1])
    cdir = str(tmp_path / "cache")
    c = CheckCache(directory=cdir)
    assert run_check(tmp_path, ["R8"], cache=c) == []
    assert c.misses == 3
    c = CheckCache(directory=cdir)
    assert run_check(tmp_path, ["R8"], cache=c) == [] and c.hits == 3
    write(tmp_path, "dmlp_tpu_torch/kernels/k.cu",
          KERNEL.replace("  // check: lowp-eps=lowp_eps", ""))
    c = CheckCache(directory=cdir)
    fs = run_check(tmp_path, ["R8"], cache=c)
    assert rules_of(fs) == ["R802"]
    assert fs[0].path == "dmlp_tpu_torch/kernels/k.cu"
    assert c.hits == 2 and c.misses == 1


def test_cache_comms_rename_invalidates_every_annotated_file(tmp_path):
    write(tmp_path, *MESH)
    write(tmp_path, "dmlp_tpu_torch/obs/comms.py", """
        def psum_traffic(nbytes, axis_size):
            return nbytes
    """)
    write(tmp_path, "dmlp_tpu_torch/train/x.py", """
        import torch.distributed as dist
        def f(x, mesh):
            # check: comms-model=psum_traffic
            dist.all_reduce(x, group=mesh.get_group("data"))
    """)
    cdir = str(tmp_path / "cache")
    assert run_check(tmp_path, ["R1"], cache=CheckCache(directory=cdir)) \
        == []
    write(tmp_path, "dmlp_tpu_torch/obs/comms.py", """
        def psum_grads_traffic(nbytes, axis_size):
            return nbytes
    """)
    c = CheckCache(directory=cdir)
    fs = run_check(tmp_path, ["R1"], cache=c)
    assert [(f.rule, f.path) for f in fs] == [
        ("R104", "dmlp_tpu_torch/train/x.py")]
    assert c.hits == 0          # the facts changed: nothing replays


# ---------------------------------------------------------------------------
# (5) obs/hlo.py's reconcile table
# ---------------------------------------------------------------------------

def _model_record(fn):
    """The CollectiveTraffic record a comms model returns at a small
    shape (every model's leading parameters are positive ints)."""
    import inspect
    params = [p for p in inspect.signature(fn).parameters.values()
              if p.default is inspect.Parameter.empty]
    args = [4 if p.name != "what" else "rows" for p in params]
    return fn(*args)


def test_model_table_keys_kinds_and_records_agree():
    from dmlp_tpu_torch.obs import comms, hlo
    table = hlo.MODEL_COLLECTIVE_KINDS
    assert {"scatter_traffic": "scatter",
            "gather_topk_traffic": "gather"}.items() <= table.items()
    for model, kind in table.items():
        fn = getattr(comms, model)
        assert callable(fn)
        assert kind in hlo.COLLECTIVE_KINDS + hlo.ROOTED_KINDS
        rec = _model_record(fn)
        if rec.collective in hlo.TRAFFIC_COLLECTIVE_KINDS:
            assert hlo.TRAFFIC_COLLECTIVE_KINDS[rec.collective] == kind, \
                (model, rec.collective)


def test_model_table_covers_the_references_and_every_annotation():
    from dmlp_tpu.obs import hlo as ref_hlo
    from dmlp_tpu_torch.check.common import ModuleInfo
    from dmlp_tpu_torch.obs import hlo
    assert ref_hlo.MODEL_COLLECTIVE_KINDS.items() <= \
        hlo.MODEL_COLLECTIVE_KINDS.items()
    named = set()
    # the annotated directories (prose elsewhere quotes the syntax)
    for path in [p for d in ("engine", "parallel", "train")
                 for p in (Path(package_root()) / d).rglob("*.py")]:
        mod = ModuleInfo(str(path), path.name, path.read_text())
        for ds in mod.directives.values():
            for d in ds:
                if d.startswith("comms-model="):
                    named.update(x for x in d.split("=", 1)[1].split(",")
                                 if x)
    assert named and named <= set(hlo.MODEL_COLLECTIVE_KINDS)
    # every model that prices a collective the port issues is named
    assert named == set(hlo.MODEL_COLLECTIVE_KINDS)
