"""ctypes bridge to the port's native parser (``io/fastparse.cpp``).

Port of ``dmlp_tpu/io/native.py``, with the port's own copy of the C++
source. At first use ``g++ -O3 -shared -fPIC`` builds it into the build
directory (``dmlp_tpu_torch/_build/``, or the compile cache:
``utils.compile_cache``, resolved at each call), named by a hash of the
source and the flags (as ``kernels.library_path`` names the CUDA
libraries), and ``ctypes`` loads it.

The C++ parser accepts exactly what it can parse as the pure-Python parser
does (``io.grammar.parse_input_text``): the same arrays, bit for bit
(correctly rounded decimals). Anything else it rejects, and then the
Python parser parses the payload, so a malformed input raises the Python
parser's ParseError, message, line and byte offset included.

``$DMLP_TPU_NO_NATIVE`` (any non-empty value) keeps the Python parser.
Where g++ is missing or the build fails, parsing falls back to the Python
parser, as in the reference: this is host parsing, outside the timed
region. ``build()`` reports what happened, for callers that must know.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np

from dmlp_tpu_torch.io.grammar import KNNInput, Params
from dmlp_tpu_torch.utils import compile_cache

SOURCE = Path(__file__).resolve().parent / "fastparse.cpp"
# The build directory when no compile cache is set.
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the last build or load failed (None when it did not)
build_error: Optional[str] = None


def library_path() -> Path:
    """The built library: keyed by the source's and the flags' hash."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return compile_cache.build_dir(BUILD_DIR) / \
        f"fastparse-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Build (when missing) and load the library once per process:
    {"path", "built", "ok", "error"}. Never raises."""
    global _lib, _tried, build_error
    with _lock:
        out = library_path()
        info = {"path": str(out), "built": False, "ok": _lib is not None,
                "error": build_error}
        if _tried:
            return info
        _tried = True
        try:
            if not out.exists():
                cxx = shutil.which("g++")
                if cxx is None:
                    raise OSError("g++ not found")
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                # check: allow-concurrency=R703 — the g++ build under the
                # lock is the once-guard: it runs at most ONCE per process
                # (_tried flips first), and concurrent parsers must block
                # until the .so exists rather than racing the compiler.
                p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                    str(SOURCE)], capture_output=True,
                                   text=True, timeout=300)
                if p.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise OSError(f"g++ exit {p.returncode}: {p.stderr}")
                os.replace(tmp, out)
                info["built"] = True
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            build_error = info["error"] = str(e)
            return info
        ll, sz, cp = ctypes.c_longlong, ctypes.c_size_t, ctypes.c_char_p
        lib.dmlp_parse_header.restype = ctypes.c_int
        lib.dmlp_parse_header.argtypes = [cp, sz, ctypes.POINTER(ll)]
        arr = np.ctypeslib.ndpointer
        lib.dmlp_parse_body.restype = ctypes.c_int
        lib.dmlp_parse_body.argtypes = [
            cp, sz, ll, ll, ll, arr(np.int32, flags="C_CONTIGUOUS"),
            arr(np.float64, flags="C_CONTIGUOUS"),
            arr(np.int32, flags="C_CONTIGUOUS"),
            arr(np.float64, flags="C_CONTIGUOUS")]
        _lib = lib
        info["ok"] = True
        return info


def native_available() -> bool:
    """The library is built and loaded, and ``$DMLP_TPU_NO_NATIVE`` is
    unset."""
    if os.environ.get("DMLP_TPU_NO_NATIVE"):
        return False
    return build()["ok"]


def parse_native(data: Union[bytes, str]) -> Optional[KNNInput]:
    """The native parse of a payload, or None where the native parser
    rejects it (the caller then runs the Python parser). ``str`` payloads
    that are not ASCII are rejected too."""
    if not native_available():
        raise RuntimeError(f"native parser unavailable: {build_error}")
    if isinstance(data, str):
        try:
            data = data.encode("ascii")
        except UnicodeEncodeError:
            return None
    hdr = (ctypes.c_longlong * 3)()
    if _lib.dmlp_parse_header(data, len(data), hdr) != 0:
        return None
    nd, nq, na = int(hdr[0]), int(hdr[1]), int(hdr[2])
    labels = np.empty(nd, np.int32)
    data_attrs = np.empty((nd, na), np.float64)
    ks = np.empty(nq, np.int32)
    query_attrs = np.empty((nq, na), np.float64)
    if _lib.dmlp_parse_body(data, len(data), nd, nq, na, labels,
                            data_attrs.reshape(-1), ks,
                            query_attrs.reshape(-1)) != 0:
        return None
    return KNNInput(Params(nd, nq, na), labels, data_attrs, ks, query_attrs)
