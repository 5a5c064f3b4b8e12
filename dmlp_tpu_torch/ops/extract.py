"""Fused distance + running top-kc extraction (K1/K2): wrapper, plain
version and tolerance.

Port of ``dmlp_tpu/ops/pallas_extract.py``. ``extract_topk`` has the
reference signature and outputs minus ``interpret`` (and minus the Pallas
``ne``/``unroll`` knobs, which have no counterpart): on a CUDA tensor it
launches the hand-written kernel ``dmlp_tpu_torch/kernels/extract_topk.cu``
(built at first use; any failure raises), on a CPU tensor it runs
:func:`extract_topk_plain`. Nothing else picks between them.

Two kernels serve one contract, picked by the operands' dtype alone
(:func:`integer_route`): uint8 queries and uint8 data of a shape it takes
go to the integer kernel (``extract_topk_kernel_u8``: the products on the
tensor cores in int32, the norms in the kernel, the bytes read as they lie
on the card; counted as ``fused_topk_u8`` / ``extract_topk_u8``); any
other pair goes to the FMA kernel on float32 copies, with the norms
computed here. On uint8 values both compute the same f32 distance for
every pair while ``na * 255^2 < 2^24``, so the lists, ids and ``iters``
are the same; the plain version follows the same split.

Outputs: (dists (Qb, kc) f32 unsorted, ids (Qb, kc) i32 — ``id_base + j``
for data row j, -1 padding — and iters (ceil(Qb/tile_q), B/tile_n) i32,
1 where query tile i processed data block j and 0 where the norm gate or
the block-min prefilter skipped it). The kernel's tiles are its own:
QUERY_TILE = 32 rows by BLOCK_ROWS = 256 columns, with the (tile_q, kc)
running lists in shared memory, so kc <= 512 fits the 227 KB a block may
opt into (:func:`variant_supports` states exactly that budget).

The data axis splits S ways (``splits``; when the caller does not say,
:func:`resolve_splits` takes the tune cache's measured S, else
:func:`choose_splits` picks it for the card). At S = 1 one CTA per query
tile sweeps every block from the carry. At S > 1 CTA (i, s) sweeps blocks
[s*nblk/S, (s+1)*nblk/S) from lists seeded with kc copies of (the
carry's row maximum, -1) — (+inf, -1) without a carry — so its gate,
prefilter and insertion compare against min(the k-th best of what it
swept, the carry's row maximum); a merge kernel then takes the exact
top-kc of carry ++ partials by (distance asc, carry first, then the
carry's own order for carry entries and id asc for the partials'), and
the lists come out sorted. A seed entry never survives the merge: the
carry's kc entries sort before it. Each block belongs to one split, so
``iters`` keeps its layout and meaning. The lists equal S = 1's as sets
for any carry: S = 1 sorts the carry stably by (distance, slot) and keeps
that order on ties, and so does the merge. (Ordering carry entries by id
instead broke this where the carry's ids lie above the chunk's, as in the
serving engine's hot-chunks-first fold.)

The merge does not sort. Every partial list the split kernel writes is
its sorted shared-memory list, already in the merge's key order: distance
ascending, the seeds (id -1) ahead of real entries at their distance,
lower ids first (list entries win ties, and blocks and positions ascend
within a split); :func:`split_partials_plain`'s lists are ordered the
same way. The kernel loads a row's 1 + S lists once, checks each list's
order and sorts a list that is out of order in place (a carry a caller
hands in unsorted), then merges pairs of lists in ceil(log2(1 + S)) rounds,
keeping the first kc of each pair; each thread finds its run of outputs
by a merge-path search. Rows with few keys share a CTA.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from dmlp_tpu_torch.check.sanitize import readback
from dmlp_tpu_torch.engine.finalize import (EPS_CANCEL_COEF, EPS_REL_F32,
                                            LOWP_COEF)
from dmlp_tpu_torch.kernels import (LAUNCHES, KernelBuildError,
                                    KernelLaunchError, note_launch)
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.ops.distance import require_ieee_f32
from dmlp_tpu_torch.tune import cache as tune_cache

QUERY_TILE = 32     # kernel TQ: query rows per CTA
BLOCK_ROWS = 256    # kernel TN: data columns per block
_AK = 16            # kernel AK: attributes per staged chunk (2 buffers)
KC_MAX = 512
# The integer kernel's staging: KB attribute bytes of a block's rows a
# chunk (row stride KB + 16), U8_STAGES chunks in flight or in use; na a
# multiple of 16 (16-byte copies) and at most U8_NA_MAX (exact int32 sums).
_KB = 128
_U8_STAGES = 2
U8_NA_MAX = 16512
MERGE_MAX = 8192    # kernel MERGE_MAX: entries one merge row holds, (1+S)*kc
# Opt-in dynamic shared memory per block on sm_90 (232,448 bytes), less
# 1 KB of headroom for the kernel's static shared memory.
SMEM_BUDGET = 232448 - 1024
# Shared memory of one sm_90 SM (228 KB) and the 1 KB the runtime reserves
# for each resident CTA: how many CTAs of a given kc share an SM.
SM_SMEM = 233472
CTA_SMEM_RESERVED = 1024
# choose_splits' cost model: a CTA that starts from empty lists spends
# about SPLIT_FILL data blocks' time per list slot filling them (the grid
# value of least excess in chip_smoke.py's split_fill_fit line, over the
# split_sweep lines of an H100 run), and S is the smallest whose modelled
# time is within SPLIT_TOL of the least.
SPLIT_FILL = 0.02
SPLIT_TOL = 0.05


def smem_bytes(kc: int, tile_q: int = QUERY_TILE,
               tile_n: int = BLOCK_ROWS) -> int:
    """Dynamic shared memory of one CTA: each warp's tile_n 64-bit
    candidate keys (one warp per 32 of the tile_n threads), distance
    tile, two buffers of staged q/d attribute chunks (d transposed, padded
    stride), three per-row vectors, and the (tile_q, kc) distance + id
    lists."""
    return 8 * (tile_n // 32) * tile_n \
        + 4 * (tile_q * tile_n + 2 * _AK * tile_q + 2 * _AK * (tile_n + 4)
               + 3 * tile_q) + 8 * tile_q * kc


def smem_bytes_u8(kc: int, na: int) -> int:
    """Dynamic shared memory of one CTA of the integer kernel: each warp's
    candidate keys, the ring of staged uint8 chunks (the distance tile is
    written into one of them), the query tile's bytes, the block's and the
    tile's int32 norms, the thresholds and floors, and the (tile_q, kc)
    lists."""
    nch = -(-na // _KB)
    return 8 * (BLOCK_ROWS // 32) * BLOCK_ROWS \
        + _U8_STAGES * BLOCK_ROWS * (_KB + 16) \
        + QUERY_TILE * (nch * _KB + 16) \
        + 4 * (BLOCK_ROWS + 3 * QUERY_TILE) + 8 * QUERY_TILE * kc


def ctas_per_sm(kc: int, u8_na: Optional[int] = None) -> int:
    """Resident CTAs per SM as shared memory allows (2 at kc 48, 1 at
    kc 512); with ``u8_na``, the integer kernel's at that many attributes
    (2 at kc 32 and 128 attributes)."""
    smem = smem_bytes(kc) if u8_na is None else smem_bytes_u8(kc, u8_na)
    return max(1, SM_SMEM // (smem + CTA_SMEM_RESERVED))


def max_splits(b: int, kc: int, tile_n: int = BLOCK_ROWS) -> int:
    """The largest S a launch takes: at least one block per split and
    (1+S)*kc entries per merge row."""
    return max(1, min(b // tile_n, MERGE_MAX // kc - 1))


def choose_splits(qb: int, b: int, kc: int, sm_count: int,
                  u8_na: Optional[int] = None) -> int:
    """S for one launch on a card with ``sm_count`` SMs; a pure function.
    ``u8_na``: the integer kernel's launch at that many attributes (its
    own shared memory, so its own CTAs per SM); None for the FMA kernel.

    CTAs = ceil(qb/32) * S run in waves of sm_count * ctas_per_sm(kc)
    slots. Each sweeps nblk/S blocks, after filling its lists from empty
    (SPLIT_FILL * kc blocks' time: every split of a fresh launch pays it,
    a carried launch's splits mostly do not), so cost(S) = waves(S) *
    (SPLIT_FILL * kc + nblk / S). Returns the smallest S whose cost is
    within SPLIT_TOL of the least: 1 where the split does not pay.
    Memoized by its arguments and the two constants: a chunk loop launches
    one shape thousands of times, and the model costs up to nblk terms."""
    return _choose_splits(qb, b, kc, sm_count, u8_na, SPLIT_FILL, SPLIT_TOL)


@functools.lru_cache(maxsize=1024)
def _choose_splits(qb: int, b: int, kc: int, sm_count: int,
                   u8_na: Optional[int], fill: float, tol: float) -> int:
    tiles = -(-qb // QUERY_TILE)
    slots = sm_count * ctas_per_sm(kc, u8_na)
    nblk = b // BLOCK_ROWS
    costs = [-(-tiles * n // slots) * (fill * kc + nblk / n)
             for n in range(1, max_splits(b, kc) + 1)]
    least = min(costs)
    return next(n for n, c in enumerate(costs, 1)
                if c <= (1 + tol) * least)


def resolve_variant(kc: int, b: int, qb: int | None = None,
                    a: int | None = None, precision: str = "f32") -> dict:
    """The kernel's tiles. They are compile-time constants of the CUDA
    source, so every shape resolves to the same; the knob a launch does
    resolve is S (:func:`resolve_splits`)."""
    return {"tile_q": QUERY_TILE, "tile_n": BLOCK_ROWS}


def heuristic_splits(qb: int, b: int, kc: int, device,
                     u8_na: Optional[int] = None) -> int:
    """S without the tune cache: :func:`choose_splits` for the card's SM
    count on a CUDA device, 1 on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    return choose_splits(qb, b, kc, torch.cuda.get_device_properties(
        device).multi_processor_count, u8_na)


def resolve_splits(qb: int, b: int, a: int, kc: int, *, device,
                   gate: bool, precision: str = "f32",
                   dtype: str = "float32") -> int:
    """S for one launch: the tune cache's measured winner (namespace
    ``fused_topk`` with the gate on, ``extract_topk`` with it off, keyed by
    the data's ``dtype``) where one exists and :func:`check_splits` takes
    it for this launch, else :func:`heuristic_splits` (with the integer
    kernel's shared memory for ``dtype`` "uint8"). A misfit never disables
    the kernel."""
    v = tune_cache.lookup_variant(
        "fused_topk" if gate else "extract_topk", qb=qb, b=b, a=a, kc=kc,
        device=device, dtype=dtype, precision=precision)
    if v is not None:
        try:
            return check_splits(v["splits"], b, kc)
        except ValueError:
            pass
    return heuristic_splits(qb, b, kc, device,
                            a if dtype == "uint8" else None)


def variant_supports(qb: int, b: int, a: int, kc: int, v: dict) -> bool:
    """Whole data blocks (b % tile_n), 1 <= kc <= 512, and the CTA's
    shared memory within the opt-in budget. Any qb >= 1 and any attribute
    count tile (ragged query tiles are masked; attributes are staged in
    chunks, so ``a`` does not enter the budget)."""
    return (qb >= 1 and a >= 1 and b >= v["tile_n"]
            and b % v["tile_n"] == 0 and 1 <= kc <= KC_MAX
            and smem_bytes(kc, v["tile_q"], v["tile_n"]) <= SMEM_BUDGET)


def supports(qb: int, b: int, a: int, kc: int) -> bool:
    return variant_supports(qb, b, a, kc, resolve_variant(kc, b, qb, a))


def supports_u8(qb: int, b: int, a: int, kc: int) -> bool:
    """The integer kernel's launch: the FMA kernel's rules, ``a`` a
    multiple of 16 (16-byte copies of whole rows) and at most U8_NA_MAX,
    and its shared memory, which grows with ``a``, within the budget."""
    return (supports(qb, b, a, kc) and a % 16 == 0 and a <= U8_NA_MAX
            and smem_bytes_u8(kc, a) <= SMEM_BUDGET)


def integer_route(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                  kc: int) -> bool:
    """Whether a launch takes the integer kernel (on the CPU its plain
    version): both operands uint8 and a shape it takes
    (:func:`supports_u8`). Read from the tensors alone; any other pair
    takes the FMA kernel on float32 copies."""
    return (q_attrs.dtype == torch.uint8 and d_attrs.dtype == torch.uint8
            and supports_u8(q_attrs.shape[0], d_attrs.shape[0],
                            q_attrs.shape[1], kc))


def _gate_coef(na: int, precision: str) -> float:
    """EPS_CANCEL_COEF * (na + 2) + LOWP_COEF — the magnitude-scale term
    of the gate's deflation (the reference kernel's constant)."""
    return EPS_CANCEL_COEF * (na + 2) + LOWP_COEF[precision]


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()  # check: lowp-eps=lowp_eps


def _tile_any(flags: torch.Tensor, tile_q: int) -> torch.Tensor:
    """(Qb,) bool -> (ceil(Qb/tile_q),) any-over-the-tile."""
    nt = -(-flags.shape[0] // tile_q)
    pad = flags.new_zeros(nt * tile_q)
    pad[:flags.shape[0]] = flags
    return pad.view(nt, tile_q).any(1)


def check_splits(splits: int, b: int, kc: int,
                 tile_n: int = BLOCK_ROWS) -> int:
    """``splits`` as an int, or ValueError where a launch cannot take it."""
    splits = int(splits)
    if not 1 <= splits <= b // tile_n:
        raise ValueError(f"splits={splits} needs 1 <= S <= {b // tile_n} "
                         f"data blocks")
    if splits > 1 and (1 + splits) * kc > MERGE_MAX:
        raise ValueError(f"splits={splits}: (1+S)*kc = {(1 + splits) * kc} "
                         f"exceeds the merge's {MERGE_MAX} entries")
    return splits


def split_partials_plain(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                         carry_d: Optional[torch.Tensor] = None,
                         carry_i: Optional[torch.Tensor] = None, *, n_real,
                         id_base=0, kc: int,
                         floor: Optional[torch.Tensor] = None,
                         precision: str = "f32", mxu_gate: bool = False,
                         block_skip: bool = True, tile_q: int = QUERY_TILE,
                         tile_n: int = BLOCK_ROWS, splits: int = 1):
    """The split kernel's plain PyTorch version, block by block: returns
    the (S, Qb, kc) lists of the S splits and ``iters``.

    Per data block of ``tile_n`` columns: the masked distances with
    ``torch.matmul`` (IEEE f32; bf16 rounds the operands first; with both
    operands uint8, the integer kernel's exact integer arithmetic), merged
    into the running lists as the exact top-kc by (dist asc, position asc)
    with the lists' entries winning ties (a stable sort of lists ++
    block). ``iters`` comes from the same per-tile predicates as the
    kernel — the norm gate against each row's threshold, then the
    block-min prefilter — and a skipped tile's rows are left untouched,
    exactly as the kernel leaves them. At S = 1 the one sweep starts from
    the carry; at S > 1 split s sweeps blocks [s*nblk/S, (s+1)*nblk/S)
    from lists seeded with (the carry's row maximum, -1). The threshold is
    the row's k-th best."""
    qb, na = q_attrs.shape
    b = d_attrs.shape[0]
    if b % tile_n:
        raise ValueError(f"data rows {b} not a multiple of tile_n {tile_n}")
    splits = check_splits(splits, b, kc, tile_n)
    dev = q_attrs.device
    integer = q_attrs.dtype == torch.uint8 and d_attrs.dtype == torch.uint8
    if integer:
        # The integer kernel's arithmetic: norms and products are exact
        # integers (float64 holds them), each distance formed exactly and
        # rounded once to f32. bf16 holds 0..255 exactly, so the precision
        # enters only through the gate's deflation.
        q64, d64 = q_attrs.double(), d_attrs.double()
        qn64, dn64 = (q64 * q64).sum(-1), (d64 * d64).sum(-1)
        qn, dn = qn64.float(), dn64.float()
    else:
        q32, d32 = q_attrs.float(), d_attrs.float()
        require_ieee_f32(q32)
        qn = (q32 * q32).sum(-1)
        dn = (d32 * d32).sum(-1)
        qx, dx = (_round_bf16(q32), _round_bf16(d32)) \
            if precision == "bf16" else (q32, d32)
    seed_d = torch.full((qb, 1), torch.inf, device=dev)
    if carry_d is not None:
        seed_d = carry_d.float().max(1, keepdim=True).values
    fl = None if floor is None else floor.float().reshape(qb)
    ntile, nblk = -(-qb // tile_q), b // tile_n
    iters = torch.zeros((ntile, nblk), dtype=torch.int32, device=dev)
    tile_of = torch.arange(qb, device=dev) // tile_q
    qpos = torch.clamp_min(qn, 0.0)
    sq = torch.sqrt(qpos)
    coef = _gate_coef(na, precision)
    parts_d, parts_i = [], []
    for sp in range(splits):
        if carry_d is None or splits > 1:
            ld = seed_d.expand(qb, kc).clone()
            li = torch.full((qb, kc), -1, dtype=torch.int32, device=dev)
        else:
            ld, li = carry_d.float().clone(), carry_i.to(torch.int32).clone()
        for j in range(sp * nblk // splits, (sp + 1) * nblk // splits):
            lo, hi = j * tile_n, (j + 1) * tile_n
            pos = torch.arange(lo, hi, device=dev)
            real = pos < n_real
            t = ld.max(1).values
            go = torch.ones(ntile, dtype=torch.bool, device=dev)
            if mxu_gate:
                dnb = dn[lo:hi]
                sdn = torch.sqrt(torch.clamp_min(dnb, 0.0))
                mn = torch.where(real, sdn, torch.inf).min()
                mx = torch.where(real, sdn, -torch.inf).max()
                dn_hi = torch.where(real, dnb, 0.0).max()
                gap = torch.clamp_min(torch.maximum(mn - sq, sq - mx), 0.0)
                lb = gap * gap
                scale = qpos + dn_hi
                eps = EPS_REL_F32 * torch.sqrt(lb * scale) + coef * scale
                lbs = lb - eps
                go = _tile_any(~torch.isnan(lbs) & (torch.clamp_min(lbs, 0.0)
                                                    < t), tile_q)
                # The plain version skips a gated-out block on the host.
                if not readback(go.any(), "extract.plain_gate"):  # check: allow-host-sync
                    continue
            if integer:
                dist = torch.clamp_min((qn64[:, None] + dn64[None, lo:hi]
                                        - 2.0 * (q64 @ d64[lo:hi].T))
                                       .float(), 0.0)
            else:
                dist = torch.clamp_min(qn[:, None] + dn[None, lo:hi]
                                       - 2.0 * (qx @ dx[lo:hi].T), 0.0)
            if fl is not None:
                dist = torch.where(dist < fl[:, None], torch.inf, dist)
            dist = torch.where(real[None, :], dist, torch.inf)
            if block_skip:
                go = go & _tile_any(dist.min(1).values < t, tile_q)
            iters[:, j] = go.to(torch.int32)
            rows = go[tile_of]
            if not readback(rows.any(),  # check: allow-host-sync
                            "extract.plain_rows"):
                continue
            alld = torch.cat([ld, dist], 1)
            alli = torch.cat([li, (id_base + pos).to(torch.int32)
                              .expand(qb, -1)], 1)
            order = torch.argsort(alld, dim=1, stable=True)[:, :kc]
            ld = torch.where(rows[:, None], torch.gather(alld, 1, order), ld)
            li = torch.where(rows[:, None], torch.gather(alli, 1, order), li)
        parts_d.append(ld)
        parts_i.append(li)
    return torch.stack(parts_d), torch.stack(parts_i), iters


def merge_partials_plain(carry_d: Optional[torch.Tensor],
                         carry_i: Optional[torch.Tensor],
                         part_d: torch.Tensor, part_i: torch.Tensor):
    """The merge kernel's plain version: per row, the exact top-kc of
    carry ++ part_0 ++ ... ++ part_{S-1} by (distance asc, carry before
    block, then carry slot asc for carry entries and id asc for partial
    ones), sorted, as successive stable sorts (slot or id, then flag, then
    distance). -0.0 is folded to +0.0 as the kernel's keys fold it."""
    nsplit, qb, kc = part_d.shape
    ds_, is_ = list(part_d.float().unbind(0)), list(part_i.int().unbind(0))
    ties = list(is_)
    flag = torch.ones((qb, nsplit * kc), dtype=torch.int32,
                      device=part_d.device)
    if carry_d is not None:
        ds_.insert(0, carry_d.float())
        is_.insert(0, carry_i.to(torch.int32))
        ties.insert(0, torch.arange(kc, dtype=torch.int32,
                                    device=part_d.device).expand(qb, kc))
        flag = torch.cat([torch.zeros_like(flag[:, :kc]), flag], 1)
    alld = torch.cat(ds_, 1) + 0.0
    alli = torch.cat(is_, 1)
    order = torch.argsort(torch.cat(ties, 1), dim=1, stable=True)
    for key in (flag, alld):
        order = torch.gather(order, 1, torch.argsort(
            torch.gather(key, 1, order), dim=1, stable=True))
    order = order[:, :kc]
    return torch.gather(alld, 1, order), torch.gather(alli, 1, order)


def extract_topk_plain(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                       carry_d: Optional[torch.Tensor] = None,
                       carry_i: Optional[torch.Tensor] = None, *, n_real,
                       id_base=0, kc: int,
                       floor: Optional[torch.Tensor] = None,
                       precision: str = "f32", mxu_gate: bool = False,
                       block_skip: bool = True, tile_q: int = QUERY_TILE,
                       tile_n: int = BLOCK_ROWS, splits: int = 1):
    """The plain PyTorch version of the kernel: the S sweeps of
    :func:`split_partials_plain`, then at S > 1 the merge of
    :func:`merge_partials_plain`."""
    part_d, part_i, iters = split_partials_plain(
        q_attrs, d_attrs, carry_d, carry_i, n_real=n_real, id_base=id_base,
        kc=kc, floor=floor, precision=precision, mxu_gate=mxu_gate,
        block_skip=block_skip, tile_q=tile_q, tile_n=tile_n, splits=splits)
    if part_d.shape[0] == 1:
        return part_d[0], part_i[0], iters
    od, oi = merge_partials_plain(carry_d, carry_i, part_d, part_i)
    return od, oi, iters


def _kernel_lib() -> ctypes.CDLL:
    from dmlp_tpu_torch import kernels
    lib = kernels.load("extract_topk")
    if not getattr(lib, "_dmlp_checked", False):
        for fn in ("dmlp_extract_tile_q", "dmlp_extract_tile_n",
                   "dmlp_extract_merge_max"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.dmlp_extract_smem_bytes.restype = ctypes.c_longlong
        lib.dmlp_extract_smem_bytes.argtypes = [ctypes.c_int]
        lib.dmlp_extract_smem_bytes_u8.restype = ctypes.c_longlong
        lib.dmlp_extract_smem_bytes_u8.argtypes = [ctypes.c_int] * 2
        got = (lib.dmlp_extract_tile_q(), lib.dmlp_extract_tile_n(),
               lib.dmlp_extract_merge_max(),
               lib.dmlp_extract_smem_bytes(KC_MAX),
               lib.dmlp_extract_smem_bytes_u8(KC_MAX, 128),
               lib.dmlp_extract_smem_bytes_u8(32, 784))
        want = (QUERY_TILE, BLOCK_ROWS, MERGE_MAX, smem_bytes(KC_MAX),
                smem_bytes_u8(KC_MAX, 128), smem_bytes_u8(32, 784))
        if got != want:
            raise KernelBuildError(
                f"extract_topk.cu tiles {got} != wrapper's {want}")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dmlp_extract_topk.restype = i
        lib.dmlp_extract_topk.argtypes = [p] * 10 + [i] * 10 + [
            ctypes.c_float, ctypes.c_float, p]
        lib.dmlp_extract_topk_u8.restype = i
        lib.dmlp_extract_topk_u8.argtypes = [p] * 8 + [i] * 9 + [
            ctypes.c_float, ctypes.c_float, p]
        lib.dmlp_extract_merge.restype = i
        lib.dmlp_extract_merge.argtypes = [p] * 6 + [i] * 3 + [p]
        lib._dmlp_checked = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# PyTorch's C accessor of the current stream's raw handle, where the build
# has one: a few microseconds a launch cheaper than a Stream object.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev: torch.device) -> int:
    if _RAW_STREAM is not None and dev.index is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _on_device(dev: torch.device):
    """``torch.cuda.device(dev)``, or nothing where ``dev`` is already the
    current device (the common case, and a few microseconds a launch)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() \
        else t.float().contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 and t.is_contiguous() \
        else t.to(torch.int32).contiguous()


def _carry_on(carry_d, carry_i, qb: int, kc: int):
    if carry_d is None:
        return None, None
    if carry_d.shape != (qb, kc) or carry_i.shape != (qb, kc):
        raise ValueError("carry must be (Qb, kc)")
    return _f32(carry_d), _i32(carry_i)


def _merge_shape(qb: int, kc: int, nsplit: int, carried: bool) -> dict:
    """The merge's launch shape as obs.counters records it."""
    return {"qb": qb, "kc": kc, "splits": nsplit, "carried": carried}


def _merge_cuda(lib, cd, ci, part_d, part_i):
    """Launch the merge kernel on the current stream; returns (od, oi)."""
    nsplit, qb, kc = part_d.shape
    # One allocation for both outputs (a few microseconds a launch).
    out = torch.empty((2, qb, kc), dtype=torch.int32, device=part_d.device)
    od, oi = out[0].view(torch.float32), out[1]
    with _on_device(part_d.device):
        rec = obs_counters.record_dispatch(
            "extract_merge", _merge_shape(qb, kc, nsplit, cd is not None),
            part_d.device)
        rc = lib.dmlp_extract_merge(
            _ptr(cd), _ptr(ci), _ptr(part_d), _ptr(part_i), _ptr(od),
            _ptr(oi), qb, kc, nsplit, _stream(part_d.device))
        if rec is not None:
            rec.done()
    if rc != 0:
        raise KernelLaunchError(f"extract_merge kernel launch failed "
                                f"(cudaError {rc})")
    LAUNCHES["extract_merge"] += 1
    return od, oi


def merge_partials(carry_d: Optional[torch.Tensor],
                   carry_i: Optional[torch.Tensor], part_d: torch.Tensor,
                   part_i: torch.Tensor):
    """The merge of (S, Qb, kc) partial lists with an optional (Qb, kc)
    carry into sorted (Qb, kc) lists: the merge kernel on CUDA tensors,
    :func:`merge_partials_plain` on CPU tensors."""
    nsplit, qb, kc = part_d.shape
    if part_i.shape != part_d.shape:
        raise ValueError("part_d and part_i must have one shape")
    if (1 + nsplit) * kc > MERGE_MAX:
        raise ValueError(f"(1+S)*kc = {(1 + nsplit) * kc} exceeds the "
                         f"merge's {MERGE_MAX} entries")
    if not part_d.is_cuda:
        obs_counters.record_dispatch("extract_merge", _merge_shape(
            qb, kc, nsplit, carry_d is not None))
        return merge_partials_plain(carry_d, carry_i, part_d, part_i)
    cd, ci = _carry_on(carry_d, carry_i, qb, kc)
    return _merge_cuda(_kernel_lib(), cd, ci, _f32(part_d), _i32(part_i))


def _launch_shape(qb: int, b: int, na: int, kc: int, carried: bool,
                  splits: int, precision: str, floor) -> dict:
    """One K1/K2 launch's shape as obs.counters records it."""
    return {"qb": qb, "b": b, "a": na, "kc": kc, "carried": carried,
            "splits": splits, "precision": precision,
            "floor": floor is not None}


def _extract_topk_cuda(q_attrs, d_attrs, carry_d, carry_i, *, n_real,
                       id_base, kc, floor, precision, mxu_gate, block_skip,
                       splits, integer=False):
    """One K1/K2 launch (and its merge at S > 1) on the current stream:
    the integer kernel on the uint8 operands as they are where
    ``integer`` (:func:`integer_route`), else the FMA kernel on float32
    copies with the norms computed here."""
    qb, na = q_attrs.shape
    b = d_attrs.shape[0]
    if not (supports_u8 if integer else supports)(qb, b, na, kc):
        raise ValueError(f"untileable (qb={qb}, b={b}, a={na}, kc={kc}): "
                         f"needs b % {BLOCK_ROWS} == 0 and kc <= {KC_MAX}")
    dev = q_attrs.device
    splits = check_splits(splits, b, kc)
    if integer:
        q, d = q_attrs.contiguous(), d_attrs.contiguous()
        if (q.data_ptr() | d.data_ptr()) % 16:
            raise ValueError("the integer kernel reads 16-byte aligned "
                             "uint8 rows")
    else:
        q = q_attrs.float().contiguous()
        d = d_attrs.float().contiguous()
        qn = (q * q).sum(-1)
        dn = (d * d).sum(-1)
    cd, ci = _carry_on(carry_d, carry_i, qb, kc)
    fl = None if floor is None else floor.float().reshape(qb).contiguous()
    for t in (d, cd, ci, fl):
        if t is not None and t.device != dev:
            raise ValueError("all inputs must be on one device")
    # At S > 1 the kernel writes (S, Qb, kc) partial lists, and the merge
    # writes the outputs.
    od = torch.empty((splits, qb, kc), dtype=torch.float32, device=dev)
    oi = torch.empty((splits, qb, kc), dtype=torch.int32, device=dev)
    iters = torch.empty((-(-qb // QUERY_TILE), b // BLOCK_ROWS),
                        dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    if integer:
        kname = "fused_topk_u8" if mxu_gate else "extract_topk_u8"
    else:
        kname = "fused_topk" if mxu_gate else "extract_topk"
    # The launches are asynchronous on the current stream. Temporaries
    # freed when this function returns (q, d, qn, dn, the partial lists)
    # go back to PyTorch's caching allocator for that stream, so only work
    # queued after these kernels can reuse their memory.
    with _on_device(dev):
        rec = obs_counters.record_dispatch(kname, _launch_shape(
            qb, b, na, kc, cd is not None, splits, precision, fl), dev)
        if integer:
            rc = lib.dmlp_extract_topk_u8(
                _ptr(q), _ptr(d), _ptr(fl), _ptr(cd), _ptr(ci), _ptr(od),
                _ptr(oi), _ptr(iters), qb, b, na, kc, int(n_real),
                int(id_base), splits, int(mxu_gate), int(block_skip),
                EPS_REL_F32, _gate_coef(na, precision), _stream(dev))
        else:
            rc = lib.dmlp_extract_topk(
                _ptr(q), _ptr(d), _ptr(qn), _ptr(dn), _ptr(fl), _ptr(cd),
                _ptr(ci), _ptr(od), _ptr(oi), _ptr(iters), qb, b, na, kc,
                int(n_real), int(id_base), splits, int(mxu_gate),
                int(block_skip), int(precision == "bf16"), EPS_REL_F32,
                _gate_coef(na, precision), _stream(dev))
        if rec is not None:
            rec.done()
    if rc != 0:
        raise KernelLaunchError(f"{kname} kernel launch failed "
                                f"(cudaError {rc})")
    note_launch(kname, splits)
    if splits == 1:
        return od[0], oi[0], iters
    return (*_merge_cuda(lib, cd, ci, od, oi), iters)


def extract_topk(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                 carry_d: Optional[torch.Tensor] = None,
                 carry_i: Optional[torch.Tensor] = None, *, n_real,
                 id_base=0, kc: int, tile_q: int | None = None,
                 tile_n: int | None = None, block_skip: bool = True,
                 mxu_gate: bool = False,
                 floor: Optional[torch.Tensor] = None,
                 precision: str = "f32", splits: int | None = None):
    """(queries (Qb, A), data chunk (B, A)) -> (dists, ids, iters); see the
    module docstring. Rows >= n_real are sentinels; data row j has global
    id id_base + j; an optional carry (Qb, kc) is folded in; ``floor``
    (Qb, 1) masks candidates below it. On CUDA the tiles are the kernel's
    and ``tile_q``/``tile_n`` may only restate them. ``splits`` is S;
    None means :func:`resolve_splits` (the tune cache's winner, else
    :func:`choose_splits` for the card on CUDA and 1 on the CPU), or 1
    with tiles other than the kernel's."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unsupported first-pass precision {precision!r}")
    if (carry_d is None) != (carry_i is None):
        raise ValueError("pass both carry_d and carry_i, or neither")
    if q_attrs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"extract_topk runs on cuda or cpu, not "
                         f"{q_attrs.device}")
    kw = dict(n_real=n_real, id_base=id_base, kc=kc, floor=floor,
              precision=precision, mxu_gate=mxu_gate, block_skip=block_skip)
    integer = integer_route(q_attrs, d_attrs, kc)
    if splits is None:
        tiles_fixed = (tile_q or QUERY_TILE) == QUERY_TILE \
            and (tile_n or BLOCK_ROWS) == BLOCK_ROWS
        splits = 1 if not tiles_fixed else resolve_splits(
            q_attrs.shape[0], d_attrs.shape[0], q_attrs.shape[1], kc,
            device=q_attrs.device, gate=mxu_gate, precision=precision,
            dtype="uint8" if integer else tune_cache.dtype_key(d_attrs))
    if q_attrs.is_cuda:
        if (tile_q or QUERY_TILE) != QUERY_TILE \
                or (tile_n or BLOCK_ROWS) != BLOCK_ROWS:
            raise ValueError(f"the CUDA kernel's tiles are fixed at "
                             f"({QUERY_TILE}, {BLOCK_ROWS})")
        return _extract_topk_cuda(q_attrs, d_attrs, carry_d, carry_i,
                                  splits=splits, integer=integer, **kw)
    qb, na = q_attrs.shape
    if integer:
        kname = "fused_topk_u8" if mxu_gate else "extract_topk_u8"
    else:
        kname = "fused_topk" if mxu_gate else "extract_topk"
        q_attrs, d_attrs = q_attrs.float(), d_attrs.float()
    obs_counters.record_dispatch(kname, _launch_shape(
        qb, d_attrs.shape[0], na, kc, carry_d is not None, splits,
        precision, floor))
    if splits > 1:
        obs_counters.record_dispatch("extract_merge", _merge_shape(
            qb, kc, splits, carry_d is not None))
    return extract_topk_plain(q_attrs, d_attrs, carry_d, carry_i,
                              tile_q=tile_q or QUERY_TILE,
                              tile_n=tile_n or BLOCK_ROWS, splits=splits,
                              **kw)


def list_tolerance(qn: torch.Tensor, dn_max: float, na: int,
                   precision: str = "f32") -> torch.Tensor:
    """Per-row distance tolerance between two implementations of the
    extraction: EPS_CANCEL_COEF * (na + 2) * (qn + dn_max), plus
    LOWP_COEF * (qn + dn_max) for a bf16 first pass — the f32 cancellation
    error of the norm-expansion form (engine.finalize.staging_eps term 2)
    that two summation orders can each commit."""
    scale = qn.double() + dn_max
    return (EPS_CANCEL_COEF * (na + 2) + LOWP_COEF[precision]) * scale


def compare_lists(od_a, oi_a, od_b, oi_b, tol: torch.Tensor) -> dict:
    """Hold list pair a against reference b under the stated tolerance:
    (1) per row, the ascending distance lists agree within ``tol`` (and
    are infinite in the same places); (2) every id whose distance lies
    below ``kth - 2*tol`` (kth = b's largest kept distance) on either side
    is in the other side's list. Returns {"ok", "max_abs_err",
    "bad_dist_rows", "bad_id_rows"}. Computed on the host: one readback
    of the lists, one of the verdict."""
    host = readback([od_a, oi_a, od_b, oi_b, tol],  # check: allow-host-sync
                    "extract.compare_lists")
    od_a, oi_a, od_b, oi_b, tol = (torch.from_numpy(h) for h in host)
    da = torch.sort(od_a.double(), 1).values
    db = torch.sort(od_b.double(), 1).values
    tol = tol.double()[:, None]
    fin = torch.isfinite(da) & torch.isfinite(db)
    same_inf = torch.isinf(da) == torch.isinf(db)
    diff = torch.where(fin, (da - db).abs(), torch.zeros_like(da))
    bad_d = ~(same_inf & (diff <= tol)).all(1)
    thr = db[:, -1:] - 2 * tol
    ia, ib = oi_a.long(), oi_b.long()
    sa, sb = torch.sort(ia, 1).values, torch.sort(ib, 1).values

    def missing(ids, dist, other_sorted):
        idx = torch.searchsorted(other_sorted, ids).clamp_max(
            other_sorted.shape[1] - 1)
        found = torch.gather(other_sorted, 1, idx) == ids
        return ((dist.double() < thr) & ~found).any(1)

    bad_i = missing(ia, od_a, sb) | missing(ib, od_b, sa)
    bad_d, bad_i, diff = readback(  # check: allow-host-sync
        [bad_d, bad_i, diff], "extract.compare_lists")
    return {"ok": not bool(bad_d.any() or bad_i.any()),
            "max_abs_err": float(diff.max()) if diff.size else 0.0,
            "bad_dist_rows": int(bad_d.sum()),
            "bad_id_rows": int(bad_i.sum())}
