"""dmlp_tpu_torch.check — the port's static checker (R0, R3, R5, R6, R7;
R1, R8, R9 and R10 are held in ``tests/test_torch_check_families.py``).

Four layers: (1) the differential — every R0, R5 and R6 fixture of the
reference's ``tests/test_check.py`` and its R7 fixtures that name no jax
call (read from that file, so the two stay the same sources) go through
the reference's analyzer under ``dmlp_tpu/...`` and the port's under
``dmlp_tpu_torch/...``, and the findings must be equal as (rule, scope,
key, line) with the package prefix mapped; R0 and R6 over the whole
port tree likewise; (2) torch-only fixtures for R3 and R7's torch
blocking calls, a bad and a clean case each; (3) the real port, clean
under its committed (empty) baseline; (4) the cache, the baseline
round trip and the CLI contract (exit codes, pure ``--json`` stdout,
``--stale-allows``, the two families that raise).
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from dmlp_tpu.check import analyzer as ref_analyzer
from dmlp_tpu_torch.check import analyzer
from dmlp_tpu_torch.check.analyzer import (UnportedFamilyError,
                                           analyze_package, analyze_paths,
                                           package_root)
from dmlp_tpu_torch.check.baseline import (default_path, diff_baseline,
                                           load_baseline, save_baseline)
from dmlp_tpu_torch.check.cache import CheckCache

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dmlp_tpu")


def write(base, rel, source):
    p = Path(base) / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return str(p)


def rules_of(findings):
    return sorted(f.rule for f in findings)


def run_check(tmp_path, families):
    return analyze_paths([str(tmp_path)], families, root=str(tmp_path))


# ---------------------------------------------------------------------------
# (1) the differential against the reference checker
# ---------------------------------------------------------------------------

_CLASSES = {"TestR0Hygiene": "R0", "TestR5Resilient": "R5",
            "TestR6MetricNames": "R6", "TestR7Concurrency": "R7"}


def _reference_fixtures():
    """(test name, family, {relpath: source}) of every fixture test of
    the ported families in the reference's test file."""
    tree = ast.parse((ROOT / "tests" / "test_check.py").read_text())
    out = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef) or cls.name not in _CLASSES:
            continue
        fam = _CLASSES[cls.name]
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            files = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name) and node.func.id == "write":
                    rel, src = node.args[1].value, node.args[2].value
                    files[rel] = src
            if fam == "R7" and any("jax" in s for s in files.values()):
                continue
            out.append((f"{cls.name}.{fn.name}", fam, files))
    return out


FIXTURES = _reference_fixtures()


def _port_source(src):
    return re.sub(r"\bdmlp_tpu\b", "dmlp_tpu_torch", src)


def _norm(findings, prefix):
    """(rule, path, scope, key, line) with the package prefix mapped."""
    def m(s):
        return s.replace(prefix, "dmlp_tpu") if prefix else s
    return sorted((f.rule, m(f.path), m(f.scope), m(f.key), f.line)
                  for f in findings)


def test_reference_fixtures_were_found():
    fams = [fam for _n, fam, _f in FIXTURES]
    assert {fam: fams.count(fam) for fam in set(fams)} == {
        "R0": 6, "R5": 7, "R6": 8, "R7": 16}


@pytest.mark.parametrize("name,family,files", FIXTURES,
                         ids=[n for n, _f, _s in FIXTURES])
def test_port_findings_equal_the_reference_on_its_fixtures(
        name, family, files, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for rel, src in files.items():
        write(ref_dir, rel, src)
        write(port_dir, rel.replace("dmlp_tpu/", "dmlp_tpu_torch/", 1),
              _port_source(src))
    want = ref_analyzer.analyze_paths([str(ref_dir)], [family],
                                      root=str(ref_dir))
    got = analyze_paths([str(port_dir)], [family], root=str(port_dir))
    assert _norm(got, "dmlp_tpu_torch") == _norm(want, None)
    # the seeded-violation fixtures catch something on both sides
    if name.split(".")[1].startswith(("test_r", "test_unused",
                                      "test_bare", "test_mutable",
                                      "test_fstring")) \
            and "clean" not in name and want:
        assert got


@pytest.mark.parametrize("family", ["R0", "R6"])
def test_whole_port_tree_equals_the_reference_checker(family):
    """Neither family is scoped by path: both checkers over the port's
    own tree, relpaths under the repository root."""
    port = str(ROOT / "dmlp_tpu_torch")
    want = ref_analyzer.analyze_paths([port], [family], root=str(ROOT))
    got = analyze_paths([port], [family], root=str(ROOT))
    assert _norm(got, None) == _norm(want, None)


def test_metric_name_pattern_mirrors_the_registry():
    from dmlp_tpu_torch.check.metricnames import _NAME_RE
    from dmlp_tpu_torch.obs.telemetry import NAME_RE
    assert _NAME_RE.pattern == NAME_RE.pattern


# ---------------------------------------------------------------------------
# (2) torch-only fixtures: R3 and R7's torch blocking calls
# ---------------------------------------------------------------------------

R3_CASES = {
    "item": ("""
        def f(t):
            return t.item()
    """, ["R301"]),
    "cpu_numpy": ("""
        def f(t):
            return t.cpu().numpy()
    """, ["R301", "R301"]),
    "tolist_of_device_value": ("""
        import torch
        def f(a):
            s = torch.sort(a).values
            return s.tolist()
    """, ["R301"]),
    "float_of_device_value": ("""
        import torch
        def f(a, b):
            s = torch.dot(a, b)
            return float(s)
    """, ["R303"]),
    "bool_of_kernel_output": ("""
        from dmlp_tpu_torch.ops.extract import extract_topk
        def f(q, d):
            od, oi, iters = extract_topk(q, d, n_real=8, kc=4)
            return bool(iters.any())
    """, ["R303"]),
    "asarray_of_device_value": ("""
        import numpy as np
        import torch
        def f(a):
            out = torch.sort(a).values
            return np.asarray(out)
    """, ["R304"]),
    "branch_on_device_value": ("""
        import torch
        def f(x):
            if torch.isfinite(x).all():
                return x
            return -x
    """, ["R305"]),
    "conditional_expression_on_device_value": ("""
        import torch.nn.functional as F
        def f(x):
            y = F.relu(x)
            return 1 if y.sum() else 0
    """, ["R305"]),
    "readback_needs_annotation": ("""
        from dmlp_tpu_torch.check.sanitize import readback
        def f(x):
            return readback(x)
    """, ["R302"]),
    "trailing_allow_does_not_leak": ("""
        import torch
        import numpy as np
        from dmlp_tpu_torch.check.sanitize import readback
        def f(x):
            h = readback(x)  # check: allow-host-sync
            return np.asarray(torch.sum(x))
    """, ["R304"]),
}
R3_CLEAN = {
    "annotated_readback_launders": """
        import torch
        from dmlp_tpu_torch.check.sanitize import readback
        def f(a):
            out = torch.sort(a).values
            out = readback(out)  # check: allow-host-sync
            return float(out[0]), out.tolist()
    """,
    "metadata_is_host": """
        import torch
        def f(a, n):
            t = torch.zeros((n, 4))
            if t.shape[0] > 2 and t.numel() and len(t) and t.is_cuda:
                return int(t.size(0)) + t.dim()
            return t.dtype
    """,
    "host_numpy_untouched": """
        import numpy as np
        def f(attrs):
            a = np.zeros((8, 4), np.float32)
            a[:4] = attrs
            return float(np.einsum("na,na->n", a, a).max()), a.tolist()
    """,
    "none_test_and_host_torch_calls": """
        import torch
        import torch.distributed as dist
        def f(x, carry):
            if carry is None:
                carry = torch.zeros_like(x)
            if torch.cuda.is_available() and dist.get_rank() == 0:
                return x + carry
            return carry
    """,
    "allow_directive": """
        def f(t):
            # check: allow-host-sync
            return t.item()
    """,
}


@pytest.mark.parametrize("case", sorted(R3_CASES))
def test_r3_torch_fixture_caught(case, tmp_path):
    src, want = R3_CASES[case]
    write(tmp_path, "dmlp_tpu_torch/engine/x.py", src)
    assert rules_of(run_check(tmp_path, ["R3"])) == want


@pytest.mark.parametrize("case", sorted(R3_CLEAN))
def test_r3_torch_fixture_clean(case, tmp_path):
    write(tmp_path, "dmlp_tpu_torch/serve/x.py", R3_CLEAN[case])
    assert run_check(tmp_path, ["R3"]) == []


def test_r3_out_of_scope_dirs_ignored(tmp_path):
    write(tmp_path, "dmlp_tpu_torch/obs/x.py", R3_CASES["item"][0])
    write(tmp_path, "dmlp_tpu_torch/train/x.py", R3_CASES["item"][0])
    assert run_check(tmp_path, ["R3"]) == []


R7_BLOCKING = {
    "cuda_synchronize": "torch.cuda.synchronize()",
    "event_synchronize": "self._ev.synchronize()",
    "stream_synchronize": "torch.cuda.current_stream().synchronize()",
    "item": "x.item()",
    "cpu": "x.cpu()",
    "tolist": "x.tolist()",
    "all_reduce": "dist.all_reduce(x)",
    "barrier": "dist.barrier()",
    "recv": "dist.recv(x, src=0)",
    "broadcast_object_list": "dist.broadcast_object_list([x], src=0)",
    "work_wait": "w = dist.all_reduce(x, async_op=True)\n"
                 "                w.wait()",
}
R7_HEAD = """
    import threading
    import torch
    import torch.distributed as dist
    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._ev = torch.cuda.Event()
        def f(self, x):
            with self._lock:
                {body}
"""


@pytest.mark.parametrize("case", sorted(R7_BLOCKING))
def test_r7_torch_blocking_call_under_lock_caught(case, tmp_path):
    write(tmp_path, "dmlp_tpu_torch/fleet/x.py",
          R7_HEAD.format(body=R7_BLOCKING[case]))
    fs = run_check(tmp_path, ["R7"])
    assert rules_of(fs) == ["R703"], fs


R7_TORCH_CLEAN = {
    "async_collective_without_wait": "dist.all_reduce(x, async_op=True)",
    "cuda_event_wait_is_device_side": "self._ev.wait()",
    "kernel_math": "y = torch.sort(x).values + 1",
}


@pytest.mark.parametrize("case", sorted(R7_TORCH_CLEAN))
def test_r7_torch_clean_under_lock(case, tmp_path):
    write(tmp_path, "dmlp_tpu_torch/fleet/x.py",
          R7_HEAD.format(body=R7_TORCH_CLEAN[case]))
    assert run_check(tmp_path, ["R7"]) == []


def test_r7_collective_via_a_helper_under_lock_caught(tmp_path):
    """A gloo collective reached through the port's helper, under the
    daemon's lock: the call chain carries the blocking."""
    write(tmp_path, "dmlp_tpu_torch/parallel/coll.py", """
        import torch.distributed as dist
        def broadcast_object(obj):
            box = [obj]
            dist.broadcast_object_list(box, src=0)
            return box[0]
    """)
    write(tmp_path, "dmlp_tpu_torch/fleet/x.py", """
        import threading
        from dmlp_tpu_torch.parallel.coll import broadcast_object
        class D:
            def __init__(self):
                self._lock = threading.Lock()
            def command(self, cmd):
                with self._lock:
                    return broadcast_object(cmd)
            def outside(self, cmd):
                with self._lock:
                    c = dict(cmd)
                return broadcast_object(c)
    """)
    fs = run_check(tmp_path, ["R7"])
    assert [(f.rule, f.scope) for f in fs] == [("R703", "D.command")]
    assert "broadcast_object" in fs[0].message


# ---------------------------------------------------------------------------
# (3) the real port and its baseline
# ---------------------------------------------------------------------------


def test_real_port_clean_under_its_baseline():
    findings = analyze_package()
    new, _matched, stale = diff_baseline(findings,
                                         load_baseline(default_path()))
    assert new == [] and stale == {}


def test_committed_port_baseline_is_empty_and_loadable():
    path = default_path()
    assert Path(path).parent == ROOT / "dmlp_tpu_torch" / "check"
    assert os.path.exists(path)
    assert sum(load_baseline(path).values()) == 0
    assert package_root() == str(ROOT / "dmlp_tpu_torch")


@pytest.mark.parametrize("family,match", [
    ("R2", "no analog"), ("R4", "no analog"), ("R11", "unknown")])
def test_unported_families_raise(family, match, tmp_path):
    with pytest.raises(UnportedFamilyError, match=match):
        analyze_paths([str(tmp_path)], [family])
    with pytest.raises(UnportedFamilyError, match=match):
        analyzer.analyze_paths_tracking([str(tmp_path)], ["R0", family])


# ---------------------------------------------------------------------------
# (4) cache, baseline round trip, CLI
# ---------------------------------------------------------------------------

METRIC_A = """
from dmlp_tpu_torch.obs.telemetry import REGISTRY
REGISTRY.counter("engine.solves")
"""
METRIC_B_BAD = """
from dmlp_tpu_torch.obs.telemetry import REGISTRY
REGISTRY.gauge("engine.solves")
"""


class TestFingerprintCache:
    def _cache(self, tmp_path):
        return CheckCache(directory=str(tmp_path / "cache"), enabled=True)

    def test_second_run_hits_and_findings_identical(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/obs/a.py", METRIC_A)
        write(tmp_path, "dmlp_tpu_torch/obs/b.py", METRIC_B_BAD)
        c1 = self._cache(tmp_path)
        cold = analyze_paths([str(tmp_path)], ["R6"], root=str(tmp_path),
                             cache=c1)
        assert c1.misses == 2 and c1.hits == 0
        c2 = self._cache(tmp_path)
        warm = analyze_paths([str(tmp_path)], ["R6"], root=str(tmp_path),
                             cache=c2)
        assert c2.hits == 2 and c2.misses == 0
        assert [f.fingerprint() for f in warm] == \
            [f.fingerprint() for f in cold]
        assert "R602" in rules_of(warm)

    def test_edit_invalidates_only_the_changed_file(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/obs/a.py", METRIC_A)
        src = write(tmp_path, "dmlp_tpu_torch/engine/x.py",
                    R3_CASES["item"][0])
        analyze_paths([str(tmp_path)], ["R3", "R6"], root=str(tmp_path),
                      cache=self._cache(tmp_path))
        Path(src).write_text("# shifted\n" + Path(src).read_text())
        c = self._cache(tmp_path)
        fs = analyze_paths([str(tmp_path)], ["R3", "R6"],
                           root=str(tmp_path), cache=c)
        assert c.hits == 1 and c.misses == 1
        assert rules_of(fs) == ["R301"]
        write(tmp_path, "dmlp_tpu_torch/engine/x.py",
              R3_CLEAN["allow_directive"])
        assert analyze_paths([str(tmp_path)], ["R3", "R6"],
                             root=str(tmp_path),
                             cache=self._cache(tmp_path)) == []

    def test_facts_change_invalidates_everyone(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/obs/a.py", METRIC_A)
        write(tmp_path, "dmlp_tpu_torch/obs/b.py", METRIC_B_BAD)
        analyze_paths([str(tmp_path)], ["R6"], root=str(tmp_path),
                      cache=self._cache(tmp_path))
        # a.py's registration changes kind: its FACTS change, so b.py's
        # cached (now wrong) verdict must be invalidated too
        write(tmp_path, "dmlp_tpu_torch/obs/a.py",
              METRIC_A.replace("counter", "gauge"))
        c = self._cache(tmp_path)
        fs = analyze_paths([str(tmp_path)], ["R6"], root=str(tmp_path),
                           cache=c)
        assert fs == [] and c.hits == 0

    def test_disabled_cache_is_noop(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/engine/x.py", R3_CASES["item"][0])
        c = CheckCache(directory=str(tmp_path / "cache"), enabled=False)
        fs = analyze_paths([str(tmp_path)], ["R3"], root=str(tmp_path),
                           cache=c)
        assert rules_of(fs) == ["R301"]
        assert not (tmp_path / "cache").exists()

    def test_cache_directory_is_the_ports(self, monkeypatch, tmp_path):
        from dmlp_tpu_torch.check import cache
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        assert cache.cache_dir().endswith(
            os.path.join(".cache", "dmlp_tpu_torch", "check"))
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)
        # the key carries the port checker's own source digest
        assert len(cache.checker_digest()) == 64


def test_baseline_new_then_baselined_then_stale(tmp_path):
    src = write(tmp_path, "dmlp_tpu_torch/engine/x.py", R3_CASES["item"][0])
    findings = run_check(tmp_path, ["R3"])
    assert findings
    new, matched, stale = diff_baseline(findings, {})
    assert new and not matched and not stale
    bl = str(tmp_path / "bl.json")
    save_baseline(bl, findings)
    new, matched, stale = diff_baseline(findings, load_baseline(bl))
    assert not new and len(matched) == len(findings) and not stale
    # line shifts keep the fingerprint (no line numbers in it)
    Path(src).write_text("# a new comment line\n" + Path(src).read_text())
    new, matched, _ = diff_baseline(run_check(tmp_path, ["R3"]),
                                    load_baseline(bl))
    assert not new and matched
    write(tmp_path, "dmlp_tpu_torch/engine/x.py",
          R3_CLEAN["allow_directive"])
    new, _, stale = diff_baseline(run_check(tmp_path, ["R3"]),
                                  load_baseline(bl))
    assert not new and stale


class TestCLI:
    def _run(self, args, **env):
        e = dict(os.environ, DMLP_TPU_CHECK_CACHE=env.pop("cache", ""),
                 **env)
        if not e["DMLP_TPU_CHECK_CACHE"]:
            e.pop("DMLP_TPU_CHECK_CACHE")
        return subprocess.run([sys.executable, "-m", "dmlp_tpu_torch.check",
                               *args], capture_output=True, text=True,
                              env=e, cwd=ROOT, timeout=120)

    # Explicit targets outside the repository keep their basename as
    # relpath, so the CLI cases use R0, which no path scopes.
    UNUSED = """
        import os
        import sys
        print(sys.argv)
    """

    def test_json_verdict_pure_stdout_and_exit_codes(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/x.py", self.UNUSED)
        r = self._run(["--json", "--families", "R0", "--no-baseline",
                       str(tmp_path / "dmlp_tpu_torch")],
                      cache=str(tmp_path / "c"))
        assert r.returncode == 1
        verdict = json.loads(r.stdout)
        assert verdict["ok"] is False
        assert [f["rule"] for f in verdict["new"]] == ["R001"]
        assert "finding" in r.stderr

    def test_write_baseline_then_clean(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/x.py", self.UNUSED)
        bl = str(tmp_path / "bl.json")
        target = str(tmp_path / "dmlp_tpu_torch")
        assert self._run(["--families", "R0", "--write-baseline",
                          "--baseline", bl, target],
                         cache=str(tmp_path / "c")).returncode == 0
        assert json.loads(Path(bl).read_text())["findings"]
        r = self._run(["--families", "R0", "--baseline", bl, target],
                      cache=str(tmp_path / "c"))
        assert r.returncode == 0 and "1 baselined" in r.stdout

    def test_stale_allows_json(self, tmp_path):
        write(tmp_path, "dmlp_tpu_torch/engine/x.py", """
            def dead(arr):
                return arr  # check: allow-host-sync
        """)
        r = self._run(["--stale-allows", "--json",
                       str(tmp_path / "dmlp_tpu_torch")])
        assert r.returncode == 1
        verdict = json.loads(r.stdout)
        assert verdict["ok"] is False
        assert verdict["stale_allows"][0]["directive"] == "allow-host-sync"

    def test_list_rules_and_usage_errors(self):
        r = self._run(["--list-rules"])
        assert r.returncode == 0
        for rule in ("R001", "R101", "R106", "R301", "R305", "R501",
                     "R602", "R703", "R801", "R903", "R1001"):
            assert rule in r.stdout
        assert "R201" not in r.stdout and "R401" not in r.stdout
        r = self._run(["--families", "R11"])
        assert r.returncode == 2 and "unknown families" in r.stderr
        r = self._run(["--families", "R2"])
        assert r.returncode == 2 and "no analog" in r.stderr

    def test_default_run_over_the_port_exits_0_without_the_reference(
            self, tmp_path):
        probe = (
            "import runpy, sys\n"
            "sys.argv = ['check', '--no-cache']\n"
            "try:\n"
            "    runpy.run_module('dmlp_tpu_torch.check', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            f" {FORBIDDEN!r})\n"
            "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
        p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stderr
        assert "0 new" in p.stdout
        assert p.stderr.splitlines()[-1] == "FORBIDDEN=[]"
