"""Synthetic labeled data for the train extension — port of
``dmlp_tpu/train/data.py``.

The two numpy streams are copies of the reference's, byte-identical for
each seed (the generators and their call order are the same):

- :func:`teacher_batches` — a learnable task: labels are the argmax of a
  fixed random linear teacher over uniform attribute vectors;
- :func:`knn_input_batches` — shuffled epochs over a parsed KNN problem
  instance's labeled data points.

:func:`prefetch_to_device` is the device feed: each rank's block of a
batch's rows (its dp block, or the a2a MoE's block of the dp x ep split)
in pinned host memory, copied with ``non_blocking`` so that ``depth``
batches are in flight while the step computes.
"""

from __future__ import annotations

import collections
from typing import Iterator, Tuple

import numpy as np
import torch


def teacher_batches(num_attrs: int, num_classes: int, batch_size: int,
                    seed: int = 42) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite stream of (x (B, A) f32, y (B,) i32) from a linear
    teacher."""
    rng = np.random.default_rng(seed)
    teacher = rng.normal(size=(num_attrs, num_classes)).astype(np.float32)
    while True:
        x = rng.uniform(-1.0, 1.0, (batch_size, num_attrs)).astype(np.float32)
        y = np.argmax(x @ teacher, axis=1).astype(np.int32)
        yield x, y


def prefetch_to_device(it: Iterator[Tuple[np.ndarray, np.ndarray]],
                       device, depth: int = 2, mesh=None, slicer=None,
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(x, y) on ``device``: this rank's block of each batch (``slicer(x,
    y, mesh)``; by default its dp block, ``train.sharding.batch_slice``),
    pinned and copied ahead, ``depth`` batches in flight. Without it the
    loop would wait a full transfer every step."""
    from dmlp_tpu_torch.train.sharding import batch_slice

    slicer = slicer or batch_slice
    device = torch.device(device)
    pin = device.type == "cuda"
    buf: collections.deque = collections.deque()
    for x, y in it:
        xs, ys = slicer(x, y, mesh)
        xt, yt = torch.from_numpy(np.ascontiguousarray(xs)), \
            torch.from_numpy(np.ascontiguousarray(ys))
        if pin:
            xt, yt = xt.pin_memory(), yt.pin_memory()
        buf.append((xt.to(device, non_blocking=pin),
                    yt.to(device, non_blocking=pin)))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def knn_input_batches(inp, batch_size: int, seed: int = 42,
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite shuffled epochs over a KNNInput's labeled data points."""
    rng = np.random.default_rng(seed)
    x_all = np.asarray(inp.data_attrs, np.float32)
    y_all = np.asarray(inp.labels, np.int32)
    n = x_all.shape[0]
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > {n} data points")
    while True:
        perm = rng.permutation(n)
        for i0 in range(0, n - batch_size + 1, batch_size):
            sel = perm[i0:i0 + batch_size]
            yield x_all[sel], y_all[sel]


__all__ = ["teacher_batches", "prefetch_to_device", "knn_input_batches"]
