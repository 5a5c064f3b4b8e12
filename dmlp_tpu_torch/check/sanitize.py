"""Runtime sanitizer: the dynamic half of the host-sync contract (R3).

``DMLP_TPU_SANITIZE=1`` (or ``--sanitize`` on the CLIs) wraps solves in
:func:`sanitized`, which has two layers:

- a :class:`torch.overrides.TorchFunctionMode` that raises
  :class:`ImplicitSyncError` on every implicit readback of a tensor by
  name: ``item``, ``tolist``, ``numpy``, ``cpu``, ``to`` towards the
  host, ``__bool__``, ``__float__``, ``__int__`` and ``__array__`` (so
  ``if t:``, ``float(t)`` and ``np.asarray(t)`` raise too). It raises on
  CPU tensors as on CUDA ones, so a CPU run has the same teeth as the
  card's; ``.to(device)`` of a CPU tensor to the CPU is the CPU run's
  staging move and passes. Torch function modes are per thread: the
  mode covers the thread that entered :func:`sanitized`.
- on a card, ``torch.cuda.set_sync_debug_mode("error")`` (process-wide),
  which catches the synchronizing operations the mode cannot see by
  name: ``nonzero``, boolean-mask indexing, a pageable host-to-device
  copy (implicit staging).

Train mode adds ``torch.autograd.detect_anomaly(check_nan=True)``: a
backward that produces a NaN raises at the op. Those NaN checks read each
gradient back on purpose (the card's sync-debug layer flags them), so in
train mode ``torch.autograd.grad`` and ``Tensor.backward`` run inside the
named fence ``sanitize.anomaly_backward``; the forward and the update
stay guarded.

The intentional syncs go through the explicit :func:`readback` (the
port's ``jax.device_get``: tensors to numpy arrays) or sit inside
:func:`fenced` (a deliberate sync that is not a readback: staging, a
gloo collective of CUDA tensors, which crosses the host, a CUDA event
fence). Both suspend the two layers for their duration and are one
Python call each when no sanitized region is open. Static R3 and this
guard agree by construction: what :mod:`.hostsync` wants annotated
``# check: allow-host-sync`` is what the guard rejects unfenced.

Known blind spot (by design): a kernel launcher in
``dmlp_tpu_torch/kernels/__init__.py`` passes raw device pointers to a
``ctypes`` entry point, which neither layer sees. The launchers queue
their kernels on the current stream and copy nothing: they issue no
synchronous copy (checked by reading them), so nothing is hidden there.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Mapping, Optional

ENV_VAR = "DMLP_TPU_SANITIZE"
_TRUTHY = ("1", "true", "on", "yes")

#: tensor methods that read a tensor back to the host
READBACK_METHODS = frozenset({
    "item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__",
    "__array__"})

_lock = threading.Lock()
_active = 0          # sanitized() regions open
_fences = 0          # fenced() regions open
_cuda_mode: Optional[int] = None   # the sync-debug mode to restore
_NULL = contextlib.nullcontext()
#: site -> deliberate syncs taken inside sanitized regions in this
#: process (every :func:`fenced` site and every :func:`readback` call
#: by its ``site``); :func:`reset_fences` clears it
FENCED: Dict[str, int] = {}


class ImplicitSyncError(RuntimeError):
    """An implicit host readback inside a sanitized region."""


def sanitize_enabled(environ: Optional[Mapping[str, str]] = None) -> bool:
    env = os.environ if environ is None else environ
    return str(env.get(ENV_VAR, "")).strip().lower() in _TRUTHY


def _device_type(target: Any) -> Optional[str]:
    import torch
    if isinstance(target, torch.Tensor):
        return target.device.type
    if isinstance(target, torch.device):
        return target.type
    if isinstance(target, str):
        return torch.device(target).type
    return None


def _to_host(args, kwargs) -> bool:
    """Does ``Tensor.to(*args, **kwargs)`` move a device tensor to the
    host?"""
    src = args[0] if args else None
    target = kwargs.get("device")
    if target is None and len(args) > 1:
        target = args[1]
    dst = _device_type(target)
    return dst == "cpu" and getattr(src, "device", None) is not None \
        and src.device.type != "cpu"


_MODE_CLASS = None


def _mode_class():
    global _MODE_CLASS
    if _MODE_CLASS is not None:
        return _MODE_CLASS
    from torch.overrides import TorchFunctionMode

    class NoImplicitReadback(TorchFunctionMode):
        """Raise on an implicit readback unless a fence is open; in train
        mode the backward runs in the anomaly checks' fence."""

        def __init__(self, train: bool = False):
            super().__init__()
            self.train = train

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if _fences == 0:
                name = getattr(func, "__name__", "")
                if self.train and name in ("grad", "backward"):
                    _note("sanitize.anomaly_backward")
                    with _fence():
                        return func(*args, **kwargs)
                if name in READBACK_METHODS or (
                        name == "to" and _to_host(args, kwargs)):
                    raise ImplicitSyncError(
                        f"implicit host readback Tensor.{name} inside a "
                        f"sanitized region (DMLP_TPU_SANITIZE): read back "
                        f"explicitly with dmlp_tpu_torch.check.sanitize."
                        f"readback, or fence a deliberate sync")
            return func(*args, **kwargs)

    _MODE_CLASS = NoImplicitReadback
    return _MODE_CLASS


def _set_cuda_mode(mode) -> None:
    import torch
    torch.cuda.set_sync_debug_mode(mode)


def _cuda_guard() -> bool:
    import torch
    return torch.cuda.is_available()


@contextlib.contextmanager
def sanitized(train: bool = False):
    """Context under which implicit readbacks raise, on the CPU and on
    the card (plus NaN checks in the backward when ``train``). Output of
    a clean program is byte-identical — the guards only turn silent
    syncs into errors."""
    global _active, _cuda_mode
    import torch
    with contextlib.ExitStack() as stack:
        with _lock:
            _active += 1
            if _active == 1 and _cuda_guard():
                _cuda_mode = torch.cuda.get_sync_debug_mode()
                if _fences == 0:
                    _set_cuda_mode("error")

        def _leave():
            global _active, _cuda_mode
            with _lock:
                _active -= 1
                if _active == 0 and _cuda_mode is not None:
                    _set_cuda_mode(_cuda_mode)
                    _cuda_mode = None

        stack.callback(_leave)
        stack.enter_context(_mode_class()(train))
        if train:
            stack.enter_context(torch.autograd.detect_anomaly(
                check_nan=True))
        yield


@contextlib.contextmanager
def _fence():
    global _fences
    with _lock:
        _fences += 1
        if _fences == 1 and _cuda_mode is not None:
            _set_cuda_mode(0)
    try:
        yield
    finally:
        with _lock:
            _fences -= 1
            if _fences == 0 and _cuda_mode is not None:
                _set_cuda_mode("error")


def _note(site: str) -> None:
    with _lock:
        FENCED[site] = FENCED.get(site, 0) + 1


def fenced(site: str):
    """A deliberate sync named ``site``: both layers stand aside until
    it closes, and the site is counted in :data:`FENCED`. A shared null
    context when no sanitized region is open."""
    if not _active:
        return _NULL
    _note(site)
    return _fence()


def reset_fences() -> None:
    with _lock:
        FENCED.clear()


def _get(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_get(v) for v in x)
    if isinstance(x, dict):
        return {k: _get(v) for k, v in x.items()}
    return x


def readback(x, site: str = "readback"):
    """The explicit readback: a tensor (or a list, tuple or dict of
    them) to numpy arrays on the host, allowed inside a sanitized
    region (counted in :data:`FENCED` under ``site``). Every call site
    is a deliberate sync and carries ``# check: allow-host-sync``."""
    if not _active:
        return _get(x)
    _note(site)
    with _fence():
        return _get(x)


def maybe_sanitized(train: bool = False, force: bool = False,
                    environ: Optional[Mapping[str, str]] = None):
    """``sanitized()`` when ``force`` or $DMLP_TPU_SANITIZE is truthy,
    else a null context — the one-liner the CLIs wrap their solve in."""
    if force or sanitize_enabled(environ):
        return sanitized(train=train)
    return contextlib.nullcontext()
