"""Build and load the hand-written CUDA kernels.

Each kernel is one ``.cu`` file in this directory with a plain ``extern "C"``
launcher. It is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library in the build directory (``dmlp_tpu_torch/_build/``, or the
compile cache: ``utils.compile_cache``, resolved at each call), named by a
hash of the source and the flags, so an edit rebuilds, and loaded with
``ctypes``; the
wrapper passes raw device pointers and PyTorch's current stream. This needs
neither ninja nor PyTorch's C++ headers. A missing ``nvcc``, a failed build
or a failed load raises ``KernelBuildError``: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from dmlp_tpu_torch.utils import compile_cache

KERNEL_DIR = Path(__file__).resolve().parent
# The build directory when no compile cache is set (``build_dir``).
BUILD_DIR = KERNEL_DIR.parent / "_build"
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("extract_topk", "dist_segmin")
# The CUDA toolkit's standard install location, tried last.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

# Kernel launches by kernel name ("fused_topk" = K1, gate on;
# "extract_topk" = K2, gate off; "extract_merge" = the merge of K1/K2's
# split partial lists, one per launch at S > 1; "fused_dist_segmin" = K3).
# A wrapper adds one where it launches its CUDA kernel, and nowhere else:
# never for the plain version.
LAUNCHES: Dict[str, int] = {"fused_topk": 0, "extract_topk": 0,
                            "extract_merge": 0, "fused_dist_segmin": 0}
# The same launches by the value of their knob: {kernel: {S or G: launches}}
# (S for K1/K2, G for K3).
LAUNCH_VARIANTS: Dict[str, Dict[int, int]] = {}
# Kernel libraries loaded into this process, by source name: :func:`load`
# adds one when it loads a library (once per name and process). A serving
# replay whose buckets were all warmed leaves it unchanged.
LOADS: Dict[str, int] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_VARIANTS.clear()


def note_launch(name: str, knob: int) -> None:
    """Count one launch of kernel ``name`` at knob value ``knob``; a
    wrapper calls it where it launches its CUDA kernel, and nowhere
    else."""
    LAUNCHES[name] += 1
    per = LAUNCH_VARIANTS.setdefault(name, {})
    per[int(knob)] = per.get(int(knob), 0) + 1


class KernelBuildError(RuntimeError):
    """nvcc is missing, the build failed, or the library did not load."""


class KernelLaunchError(RuntimeError):
    """A kernel's launcher returned a CUDA error."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    standard install location; raises when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built and there is no fallback")


def source_path(name: str) -> Path:
    return KERNEL_DIR / f"{name}.cu"


def source_hash(name: str) -> str:
    """The hash of ``name``'s source and the nvcc flags (16 hex digits):
    the built library's name, and the stamp of the tune cache's entries
    measured on that build."""
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """The compile cache's directory when one is set, else
    :data:`BUILD_DIR`; resolved at each call."""
    return compile_cache.build_dir(BUILD_DIR)


def library_path(name: str) -> Path:
    """The built library in :func:`build_dir`: keyed by
    :func:`source_hash`."""
    return build_dir() / f"{name}-{source_hash(name)}.so"


def build_command(name: str, nvcc: str = "nvcc") -> Tuple[List[str], Path]:
    """(argv, temporary output path) of the nvcc call that builds ``name``;
    the output is renamed onto :func:`library_path` when nvcc succeeds."""
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))], tmp


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Build every missing library, one nvcc per source, all started
    together. Returns {name: {"path", "built", "log"}}; raises
    KernelBuildError naming the first source that failed."""
    names = list(names)
    todo = [n for n in names if not library_path(n).exists()]
    info = {n: {"path": str(library_path(n)), "built": False, "log": ""}
            for n in names}
    if not todo:
        return info
    nvcc = find_nvcc()
    for n in todo:
        library_path(n).parent.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        argv, tmp = build_command(n, nvcc)
        procs.append((n, tmp, subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = None
    for n, tmp, p in procs:
        log, _ = p.communicate()
        info[n]["log"] = log
        if p.returncode != 0:
            failed = failed or (n, p.returncode, log)
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(n))
        library_path(n).with_suffix(".log").write_text(log)
        info[n]["built"] = True
    if failed:
        n, rc, log = failed
        raise KernelBuildError(f"nvcc failed for {source_path(n).name} "
                               f"(exit {rc}):\n{log}")
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed (cached)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # check: allow-concurrency=R703 — the nvcc build under the
            # lock is the once-guard: every launcher needs the library,
            # so a second caller must wait for the first one's build
            # rather than race it on the same output file.
            build_all([name])
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelBuildError(
                    f"cannot load {library_path(name)}: {e}") from e
            _loaded[name] = lib
            LOADS[name] = LOADS.get(name, 0) + 1
        return lib
