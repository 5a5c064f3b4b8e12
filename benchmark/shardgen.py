"""Seeded shards of a corpus held over several cards, drawn block by block.

A configuration with ``"dtype": "uint8"`` (BIGANN) is a corpus of
``num_data`` rows of ``num_attrs`` integer values uniform in 0..255 with
labels uniform in ``num_labels`` classes, split over the ``R`` ranks of the
data axis: rank r holds rows ``[r * S, min((r + 1) * S, num_data))``,
``S = ceil(num_data / R)``. Each rank draws its own shard on its own
device, one block of ``block_rows`` rows at a time, each block from a
generator of its own (``datagen.stream_seed(seed, "bigann/<r>/<b>")``):
first the block's values, then its labels. So any block can be drawn again
alone, on the same kind of device, bit for bit: the reference and the
judge read the corpus that way and never the program's tensor.

The queries are drawn on the host with numpy from their own stream, the
same on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np

from benchmark.datagen import stream_seed


def shard_span(config: Dict[str, Any], ranks: int, rank: int
               ) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s shard in global rows."""
    n = int(config["num_data"])
    s = -(-n // ranks)
    return min(rank * s, n), min((rank + 1) * s, n)


def blocks(rows: int, block_rows: int) -> Iterator[Tuple[int, int, int]]:
    """(block index, first row, stop row) of a shard of ``rows`` rows, in
    shard-local rows."""
    for b, lo in enumerate(range(0, rows, block_rows)):
        yield b, lo, min(lo + block_rows, rows)


def fill_block(config: Dict[str, Any], seed: int, rank: int, block: int,
               attrs, labels) -> None:
    """Draw block ``block`` of rank ``rank``'s shard into ``attrs`` (rows,
    A) uint8 and ``labels`` (rows,) int32, contiguous tensors on one
    device."""
    import torch
    g = torch.Generator(device=attrs.device)
    g.manual_seed(stream_seed(seed, f"bigann/{rank}/{block}"))
    attrs.random_(0, 256, generator=g)
    labels.random_(0, int(config["num_labels"]), generator=g)


def draw_block(config: Dict[str, Any], seed: int, rank: int, block: int,
               rows: int, device):
    """Block ``block`` of rank ``rank``'s shard drawn again alone:
    (attrs (rows, A) uint8, labels (rows,) int32) on ``device``."""
    import torch
    attrs = torch.empty((rows, int(config["num_attrs"])), dtype=torch.uint8,
                        device=device)
    labels = torch.empty(rows, dtype=torch.int32, device=device)
    fill_block(config, seed, rank, block, attrs, labels)
    return attrs, labels


def draw_shard(config: Dict[str, Any], seed: int, rank: int, ranks: int,
               block_rows: int, device):
    """Rank ``rank``'s whole shard, (attrs (rows, A) uint8, labels (rows,)
    int32) on ``device``, each block drawn in place."""
    import torch
    lo, hi = shard_span(config, ranks, rank)
    attrs = torch.empty((hi - lo, int(config["num_attrs"])),
                        dtype=torch.uint8, device=device)
    labels = torch.empty(hi - lo, dtype=torch.int32, device=device)
    for b, a, z in blocks(hi - lo, block_rows):
        fill_block(config, seed, rank, b, attrs[a:z], labels[a:z])
    return attrs, labels


def queries(config: Dict[str, Any], seed: int) -> np.ndarray:
    """The whole query set, (num_queries, A) uint8 on the host."""
    rng = np.random.default_rng(stream_seed(seed, "bigann/queries"))
    return rng.integers(0, 256, (int(config["num_queries"]),
                                 int(config["num_attrs"])), dtype=np.uint8)
