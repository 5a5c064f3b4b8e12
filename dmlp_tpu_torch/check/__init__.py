"""Static analysis and runtime sanitizers for the ``dmlp_tpu_torch`` tree
(``python -m dmlp_tpu_torch.check``) — port of ``dmlp_tpu/check``.

An AST-based pass (stdlib ``ast``, no dependencies) over the whole
package — and a text pass over its CUDA sources — enforcing the
repo-specific rule families that carry over to PyTorch:

- **R0 hygiene** (:mod:`.hygiene`): the conservative ruff subset
  (unused imports, bare except, mutable default args, pointless
  f-strings).
- **R3 host-sync hazards** (:mod:`.hostsync`): ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/``int()``/
  ``bool()``/``np.asarray`` of device tensors and branches on them in
  ``engine/``, ``ops/``, ``parallel/``, ``serve/`` and ``fleet/``, with
  a ``# check: allow-host-sync`` allowlist for the fenced readbacks that
  are intentional.
- **R5 resilience swallowing** (:mod:`.resilient`): broad ``except
  Exception`` without re-raise or ``# check: no-retry`` in the
  resilience/serving error paths.
- **R6 metric-name contract** (:mod:`.metricnames`): literal
  snake_case registry names, one kind per name package-wide.
- **R7 concurrency discipline** (:mod:`.concurrency`): lock-order
  inversions over the inferred package lock graph, guarded-field
  accesses outside their lock (incl. mutable reference escapes),
  blocking calls under a lock (CUDA fences, readbacks and
  ``torch.distributed`` collectives included), and thread-lifecycle
  holes.

- **R1 collective-axis contract** (:mod:`.collectives`,
  :mod:`.dispatchcost`): every ``torch.distributed`` collective's
  process group resolves to a declared mesh axis (of the module's own
  mesh, where it builds one), and in ``engine/``, ``parallel/`` and
  ``train/`` it carries ``# check: comms-model=<fn>`` naming its
  ``obs/comms.py`` model (or ``# check: no-traffic`` with a reason);
  the engines' top-k kernel calls thread a ``MeasuredIters`` probe, and
  every recorded or counted kernel has an ``obs/kernel_cost.py`` model.
- **R8 low-precision contract** (:mod:`.lowprec`): over
  ``kernels/*.cu`` and the ops wrappers, no half accumulators, no
  products on sub-f32 operands, no TF32 anywhere, and every sub-f32
  cast names its ``engine/finalize.py`` eps bound
  (``lowp-eps=<fn>``).
- **R9 DTensor placement contract** (:mod:`.autoshard`): mesh dims
  named from declared axes, one placement per mesh dim, explicit
  placements in ``engine/auto.py``.
- **R10 reconcile contract** (:mod:`.hlointro`): every comms-model
  annotation is a key of ``obs/hlo.py``'s ``MODEL_COLLECTIVE_KINDS``.

R2 and R4 (jit recompiles, jax API drift) have no torch analog; asking
for either raises (:func:`.analyzer.check_families`).

Cross-module context flows through the cacheable facts layer
(:mod:`.facts`), and verdicts are cached per file content hash
(:mod:`.cache`) so re-runs only re-analyze changed files;
``--stale-allows`` reports allow-directives that no longer suppress
anything. Accepted pre-existing findings are pinned in
``dmlp_tpu_torch/check/check_baseline.json`` (:mod:`.baseline`); any
NEW finding fails the run. The runtime side lives in :mod:`.sanitize`
(``DMLP_TPU_SANITIZE=1`` / ``--sanitize``: implicit readbacks raise, on
the CPU and on the card) and :mod:`.racecheck` (``DMLP_TPU_RACECHECK=1``:
instrumented lock factories record real acquisition orders, catching
actual inversions and blocking-under-lock as they happen;
:mod:`.race_stress` drives a live daemon under it).
"""

from dmlp_tpu_torch.check.analyzer import analyze_package, analyze_paths
from dmlp_tpu_torch.check.baseline import (diff_baseline, load_baseline,
                                           save_baseline)
from dmlp_tpu_torch.check.findings import Finding
from dmlp_tpu_torch.check.sanitize import (fenced, readback,
                                           sanitize_enabled, sanitized)

__all__ = [
    "Finding", "analyze_package", "analyze_paths", "load_baseline",
    "save_baseline", "diff_baseline", "sanitize_enabled", "sanitized",
    "readback", "fenced",
]
