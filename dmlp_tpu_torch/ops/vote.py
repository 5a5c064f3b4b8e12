"""Majority vote and report ordering on the device.

Port of ``dmlp_tpu/ops/vote.py``: the reference's result post-processing
(engine.cpp:314-347) as batched tensor code, so that ``--device-full``
keeps the whole pipeline on the device. In the reference this is a jitted
``jnp`` epilogue, not a Pallas kernel, so there is no kernel to write: it
is plain PyTorch on whichever device holds the lists.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmlp_tpu_torch.ops.topk import TopK


def majority_vote(labels: torch.Tensor, valid: torch.Tensor,
                  num_labels: int) -> torch.Tensor:
    """(Q,) int32 majority label per query over the (Q, K) candidates
    where ``valid`` holds; ties go to the larger label, and the result is
    -1 where no candidate is valid (engine.cpp:320-332). A label outside
    [0, num_labels) counts for nothing, as the reference's one-hot.

    The tie rule is computed explicitly (the largest label whose count
    equals the row's maximum), not left to how ``argmax`` breaks ties."""
    q = labels.shape[0]
    take = valid & (labels >= 0) & (labels < num_labels)
    counts = torch.zeros((q, num_labels), dtype=torch.int32,
                         device=labels.device)
    counts.scatter_add_(1, torch.where(take, labels, 0).long(),
                        take.to(torch.int32))
    best = counts.max(-1, keepdim=True).values
    arange = torch.arange(num_labels, dtype=torch.int32, device=labels.device)
    predicted = torch.where(counts == best, arange, -1).max(-1).values
    return torch.where(best[:, 0] > 0, predicted, -1).to(torch.int32)


def report_order(topk: TopK, ks: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask each selection-ordered list past its own k to (+inf, -1) and
    sort it into the report order (distance asc, id desc). Returns
    ``(dists, ids, in_k)``, ``in_k`` marking each row's first k slots —
    the slots the report prints (padded ones print the -1 sentinel).

    Two stable sorts, least-significant key first: id descending, then
    distance ascending."""
    kmax = topk.ids.shape[1]
    in_k = torch.arange(kmax, device=ks.device)[None, :] < ks[:, None]
    d = torch.where(in_k, topk.dists, torch.inf)
    ids = torch.where(in_k, topk.ids, -1)
    order = torch.argsort(-ids, dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(
        torch.gather(d, 1, order), dim=1, stable=True))
    return torch.gather(d, 1, order), torch.gather(ids, 1, order), in_k
