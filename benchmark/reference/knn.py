"""Plain k-nearest-neighbour search, vote and checksum: the reference
every cell is judged against.

Written from the contract the program serves (the reference harness's
``engine.cpp`` / ``common.cpp`` semantics), not from the program's code,
and importing none of it:

- distance: squared Euclidean, float64, difference form;
- selection and report order: distance ascending, ties to the larger id;
- vote: majority over the selected k, ties to the larger label, -1 when no
  neighbour is valid;
- checksum: FNV-1a over the label, then each neighbour id + 1, in report
  order.

``knn`` runs in blocks of queries on whichever device holds the tensors.
In float64 it is exact: the expansion ``|q|^2 - 2 q.x + |x|^2`` (one
matrix product per block) only picks candidates, whose distances are then
recomputed in the difference form and ordered by the tie rule; a row whose
candidate set cannot be shown to hold its whole tie group is recomputed
over every row of the corpus. ``precision="float32"`` and ``"tf32"`` are
the lower precisions the controls put in the program's place: the
expansion in float32 (TF32 off) or with its product in TF32, no exact
recomputation, the order taken from those values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

FNV_BASIS = 1469598103934665603
FNV_PRIME = 1099511628211

#: extra candidates the float64 pass carries past k before recomputing
MARGIN = 16
PRECISIONS = ("float64", "float32", "tf32")


def _order(d: torch.Tensor, ids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of (dist, id) sorted by distance ascending, ties to the larger
    id: two stable sorts, least significant key first."""
    o = torch.argsort(-ids, dim=1, stable=True)
    d, ids = torch.gather(d, 1, o), torch.gather(ids, 1, o)
    o = torch.argsort(d, dim=1, stable=True)
    return torch.gather(d, 1, o), torch.gather(ids, 1, o)


def exact_dists(queries: torch.Tensor, data: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Float64 difference-form distances of each query to the rows
    ``ids`` (Q, m) of ``data``; ids outside the corpus read +inf."""
    n = data.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = data[torch.where(ok, ids, 0)]
    diff = rows - queries[:, None, :]
    d = (diff * diff).sum(-1)
    return torch.where(ok, d, torch.inf)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10 fraction bits (nearest): the
    operand rounding a TF32 tensor-core product applies, for devices that
    have no TF32 unit."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _expansion(q: torch.Tensor, data: torch.Tensor, dn: torch.Tensor,
               precision: str) -> torch.Tensor:
    if precision == "tf32" and q.device.type != "cuda":
        dot = _tf32_round(q) @ _tf32_round(data).T
    elif precision == "tf32":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            dot = q @ data.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    else:
        dot = q @ data.T
    qn = (q * q).sum(1, keepdim=True)
    return qn - 2.0 * dot + dn[None, :]


def knn(queries: torch.Tensor, data: torch.Tensor, k: int, *,
        precision: str = "float64", query_block: int = 1024
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, k) float64, ids (Q, k) int64) of each query's k nearest
    rows in report order; rows short of k candidates pad with (+inf, -1).
    ``queries`` and ``data`` are float64 tensors on one device."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    prev = None
    if queries.device.type == "cuda":
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _knn(queries, data, k, precision, query_block)
    finally:
        if prev is not None:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def _knn(queries, data, k, precision, query_block):
    n = data.shape[0]
    dev = data.device
    work = data if precision == "float64" else data.float()
    dn = (work * work).sum(1)
    dn_max = float(data.pow(2).sum(1).max()) if n else 0.0
    kk = min(k + (MARGIN if precision == "float64" else 0), n)
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], query_block):
        q64 = queries[q0:q0 + query_block]
        q = q64 if precision == "float64" else q64.float()
        d = _expansion(q, work, dn, precision)
        cd, ci = torch.topk(d, kk, dim=1, largest=False)
        if precision != "float64":
            cd, ci = _order(cd.double(), ci)
            out_d.append(cd[:, :k])
            out_i.append(ci[:, :k])
            continue
        ed = exact_dists(q64, data, ci)
        ed, ei = _order(ed, ci)
        if kk < n:
            # The candidates hold the whole tie group of the k-th distance
            # unless the last candidate's expansion value could equal it.
            qn = (q64 * q64).sum(1)
            tol = 1e-9 * (qn + dn_max) + 1e-300
            unsure = cd[:, -1] <= ed[:, k - 1] + tol
            for r in torch.nonzero(unsure).flatten().tolist():
                full = torch.arange(n, device=dev)[None, :]
                fd = exact_dists(q64[r:r + 1], data, full)
                fd, fi = _order(fd, full)
                ed[r], ei[r] = fd[0, :kk], fi[0, :kk]
        out_d.append(ed[:, :k])
        out_i.append(ei[:, :k])
    d = torch.cat(out_d)
    i = torch.cat(out_i)
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, torch.full((d.shape[0], pad), torch.inf,
                                     dtype=d.dtype, device=dev)], 1)
        i = torch.cat([i, torch.full((i.shape[0], pad), -1,
                                     dtype=i.dtype, device=dev)], 1)
    return d, i


def vote(labels: torch.Tensor, ids: torch.Tensor,
         num_labels: int) -> torch.Tensor:
    """(Q,) majority label over each row's valid ids (ties to the larger
    label; -1 where none is valid)."""
    n = labels.shape[0]
    ok = (ids >= 0) & (ids < n)
    lab = torch.where(ok, labels[torch.where(ok, ids, 0)].long(), 0)
    counts = torch.zeros((ids.shape[0], num_labels), dtype=torch.int64,
                         device=ids.device)
    counts.scatter_add_(1, lab, ok.long())
    best = counts.max(1, keepdim=True).values
    cls = torch.arange(num_labels, device=ids.device)[None, :]
    pred = torch.where(counts == best, cls, -1).max(1).values
    return torch.where(best[:, 0] > 0, pred, -1)


def checksums(pred: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(Q,) uint64 FNV-1a checksums of (label, ids in report order)."""
    with np.errstate(over="ignore"):
        prime = np.uint64(FNV_PRIME)
        c = np.full(len(pred), FNV_BASIS, np.uint64)
        c ^= np.asarray(pred, np.int64).view(np.uint64)
        c *= prime
        for j in range(ids.shape[1]):
            c ^= (np.asarray(ids[:, j], np.int64) + 1).view(np.uint64)
            c *= prime
    return c
