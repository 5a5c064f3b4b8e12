"""The build directory of the native libraries — port of
``dmlp_tpu/utils/compile_cache.py``.

In the port the "compile cache" is the directory that holds what the
package compiles at first use: the CUDA kernel libraries that
``kernels`` builds with nvcc and the native parser that ``io.native``
builds with g++. Each library's file name is keyed by a hash of its
source and flags, and each build lands by an atomic rename, so one
directory can be shared by every process of a run: the mesh ranks, the
daemon's workers, every fleet replica and its relaunches. The first
process builds; the others load.

Every entry point takes ``--compile-cache DIR``:

- engine CLI: ``python -m dmlp_tpu_torch --compile-cache DIR``;
- serve daemon: ``python -m dmlp_tpu_torch.serve --compile-cache DIR``;
- train loop: ``python -m dmlp_tpu_torch.train.loop --compile-cache DIR``;
- tune: ``python -m dmlp_tpu_torch.tune --compile-cache DIR``;
- fleet: ``ReplicaSpec`` / ``spawn_replica`` pass it to every spawn,
  supervisor relaunch and re-split.

``$DMLP_TPU_COMPILE_CACHE`` is the ambient form (the flag wins when both
are set). :func:`enable_from_flag` exports the directory it enables into
that variable, so every process this one starts builds into and loads
from the same place. Without either, the libraries go to
``dmlp_tpu_torch/_build/``.

Unlike the reference, whose opt-in is best-effort (an XLA cache is an
optimization only), a directory named here that cannot be created or
written raises :class:`CompileCacheError`: the libraries must be built
somewhere, and a run that silently built them elsewhere would defeat the
sharing the caller asked for.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

#: ambient opt-in; the explicit --compile-cache flag wins when both set
ENV_VAR = "DMLP_TPU_COMPILE_CACHE"


class CompileCacheError(RuntimeError):
    """The named build directory cannot be created or written."""


def resolve_cache_dir(flag: Optional[str] = None) -> Optional[str]:
    """The effective cache directory: the explicit flag when given, else
    ``$DMLP_TPU_COMPILE_CACHE`` when set non-empty, else None. Read per
    call (no import-time snapshot) so spawned subprocesses and tests can
    flip the environment without re-imports."""
    if flag:
        return flag
    env = os.environ.get(ENV_VAR)
    return env if env else None


def _check_writable(directory: str) -> None:
    try:
        os.makedirs(directory, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=directory, prefix=".probe-"):
            pass
    except OSError as e:
        raise CompileCacheError(
            f"compile cache {directory!r} cannot be created or written: "
            f"{e}") from e


def enable_from_flag(flag: Optional[str] = None) -> Optional[str]:
    """Resolve flag and environment; when either names a directory,
    create it, check that it can be written (else raise
    :class:`CompileCacheError`) and export its absolute path as
    ``$DMLP_TPU_COMPILE_CACHE`` for this process and its children.
    Returns the directory, or None when nothing was asked for."""
    directory = resolve_cache_dir(flag)
    if not directory:
        return None
    directory = os.path.abspath(directory)
    _check_writable(directory)
    os.environ[ENV_VAR] = directory
    return directory


def build_dir(default: Path) -> Path:
    """Where the native libraries are built and loaded from, resolved per
    call: the cache directory when one is set, else ``default``."""
    directory = resolve_cache_dir()
    return Path(directory) if directory else default
