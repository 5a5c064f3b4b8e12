// Fused distance + running top-kc by sorted per-block merges, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel dmlp_tpu/ops/pallas_extract.py::_kernel
// (pallas_call at :499), reached through extract_topk (:390, K2: norm gate
// off) and dmlp_tpu/ops/pallas_fused.py::fused_topk (:108, K1: gate on).
// One source serves both: MXU_GATE, BLOCK_SKIP and BF16 are compile-time
// template flags; n_real and id_base are run-time arguments, so one build
// serves every chunk of a solve.
//
// Contract (the K1/K2 contract of the reference):
//   d(i, j) = max(qn_i + dn_j - 2 q_i.d_j, 0), +inf where d < floor_i or
//   position j >= n_real; the output lists hold the kc smallest distances of
//   carry U block (a multiset), unsorted, with ids id_base + j (-1 padding).
//   Insertion is strict (m < T); on equal distances the lowest position is
//   extracted first, and the entry evicted is the one holding T that sorts
//   last in the list, so carry entries and earlier positions win ties. At
//   S > 1 the merge keeps the same rule: (distance asc, carry first in the
//   carry's own order, then id asc), so the lists equal S = 1's as sets
//   whatever the carry's ids. iters[i, j] = 1 when query tile i processed
//   data block j, 0 when
//   the norm gate or the block-min prefilter skipped it.
//
// Design. The grid is (ceil(Qb/TQ), S). CTA (i, s) owns TQ = 32 query rows
// and sweeps the data blocks [s*nblk/S, (s+1)*nblk/S) of TN = 256 columns.
// At S = 1 the lists are seeded from the carry and written to the output.
// At S > 1 every CTA seeds its lists with kc copies of (the carry's row
// maximum, id -1), +inf without a carry, and writes its partial lists to
// an (S, Qb, kc) scratch; extract_merge_kernel then takes the exact top-kc
// of carry ++ partials. A split's k-th best is then min(the k-th best of
// what it swept, the carry's row maximum), which is the threshold of its
// gate, prefilter and insertion: entries the carry already beats are never
// inserted, and a seed entry never survives the merge, since the carry's
// kc entries all sort before it.
//
// The (TQ x kc) lists live in shared memory for the whole sweep, each row
// sorted ascending, so a row's threshold T is its last entry. A carry is
// sorted once at the start by (distance, slot), stably (it is checked
// first: a sorted carry is copied as it is). Per block:
//   1. (MXU_GATE) one block-wide reduction of the block's real |d| range
//      gives every row a lower bound (|q| - |d|)^2 deflated by the f32
//      error bound of engine/finalize.py; when no row's bound beats its
//      T the block is skipped before any product.
//   2. The (TQ x TN) distance tile is computed on the CUDA cores with IEEE
//      float32 FMAs (never TF32: the eps bounds hold only for full f32
//      products), each (row, column) summed over the attributes in order.
//      Thread t owns an RT x CT = 8 x 4 register micro-tile: per attribute
//      three float4 shared loads feed 32 FMAs. The attributes arrive AK =
//      16 at a time by cp.async into a double buffer (the data chunk
//      transposed with a padded stride), chunk k + 1 in flight while chunk
//      k's FMAs run, and the next block's first chunk while this block's
//      lists are merged. BF16 rounds both operands to bfloat16
//      (round-to-nearest-even) once staged and still accumulates in f32.
//   3. One warp per row: each lane holds 8 of the row's tile values, a
//      ballot per value against T selects the candidates (m < T) and popc
//      counts them. A row without one costs its ballots and nothing more.
//      Otherwise the candidates are compacted, in position order, as
//      64-bit keys (distance bits, position) and sorted, then merged into
//      the list by rank, in place: a list entry j moves to j +
//      #(candidates < it), so list entries win ties; candidate i goes to
//      i + #(list entries <= it); ranks past kc drop. Up to 32 candidates
//      are sorted in registers (one key per lane) and each list entry's
//      move is counted from the candidates' slots broadcast by shuffles;
//      more (the first blocks of a fresh list) are sorted in the warp's
//      shared scratch and ranked by binary search. This is exactly a
//      stable sort of list ++ block, the plain version's rule.
//      (BLOCK_SKIP) the OR of the ballots over the tile is the block-min
//      prefilter: a block no row takes anything from reads iters 0.
//
// What bounds it on the card: the operations are 2*Qb*B*A FLOP on the
// FP32 pipes (no tensor cores), about 2.1 us a block for one CTA at the
// card's peak; the bytes (the data re-read per query tile, from L2) are
// far below that. Measured on an H100 (chip_smoke.py's tile_block_us and
// block_us), a block takes about 10 us for the tile alone and 14-23 us with
// the list merges at one CTA per SM (kc 512): the kernel is bound by
// latency, not by the FMA rate. The block's phases (staging, product,
// extraction) are separated by barriers, and a merge is a chain of
// dependent shared-memory steps per row; two CTAs per SM (kc 48) overlap
// each other's phases and move 1.6 times the blocks an SM moves alone,
// which the 128 KB lists of kc 512 do not leave room for. With few query
// tiles (1,024 queries make 32 CTAs) the split of the data axis is what
// fills the 132 SMs.
//
// The merge (extract_merge_kernel): one CTA per row packs carry ++ partials
// into 64-bit keys (distance bits, then a carry/block flag, then the slot
// for a carry entry and id + 1 for a partial one), bitonic-sorts them in
// shared memory and writes the first kc, sorted, reading a carry entry's
// id back from its slot. Carry entries keep the order S = 1 gives them
// (sorted by (distance, slot)), not the order of their ids: a carry folded
// from a later chunk than the block, as the serving engine's hot-chunks-
// first order folds, holds tie groups whose ids do not ascend in slot
// order, and ordering them by id would evict other members of a tie group
// at the boundary than S = 1 does.
// Non-negative floats and +inf order as unsigned integers; -0.0 is folded
// to +0.0 first. It moves (1+S)*Qb*kc*8 bytes and is bound by them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int TQ = 32;          // query rows per CTA
constexpr int TN = 256;         // data columns per block (= threads per CTA)
constexpr int NT = 256;         // threads per CTA
constexpr int NW = NT / 32;     // warps per CTA
constexpr int AK = 16;          // attributes per staged chunk (2 buffers)
constexpr int DS = TN + 4;      // padded row stride of the transposed data chunk
constexpr int RT = 8;           // tile rows of one thread's micro-tile
constexpr int CT = 4;           // tile columns of one thread's micro-tile
static_assert(TQ * TN == NT * RT * CT, "the micro-tiles cover the tile");
constexpr int VPL = TN / 32;    // tile columns each lane holds during extraction
constexpr int KC_MAX = 512;     // the widest list
constexpr int KPL = KC_MAX / 32;  // list entries a lane moves in one merge
constexpr int MT = 256;         // threads per merge CTA
constexpr int MERGE_MAX = 8192; // entries one merge row may hold ((1+S)*kc)
constexpr unsigned FULL = 0xffffffffu;
// The seeding sort borrows the distance tile as NW x KC_MAX keys.
static_assert(sizeof(float) * TQ * TN >= sizeof(u64) * NW * KC_MAX,
              "the distance tile must hold the seeding sort's keys");

__device__ __forceinline__ float to_bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of attribute chunk [a0, a0 + AK) of the query tile and of
// data block c0 into one buffer (qsb [AK][TQ]; dsb [AK][DS], transposed),
// as one cp.async group; attributes past na and rows past nrows are
// zero-filled by the copy (a zero product leaves the f32 sum unchanged).
__device__ __forceinline__ void stage_chunk(float* qsb, float* dsb,
                                            const float* q, const float* d,
                                            int row0, int nrows, int c0,
                                            int na, int a0, int tid) {
  for (int idx = tid; idx < TQ * AK; idx += NT) {
    const int ak = idx / TQ, r = idx - ak * TQ;
    const bool ok = r < nrows && a0 + ak < na;
    cp_async4(qsb + idx, ok ? q + (size_t)(row0 + r) * na + a0 + ak : q, ok);
  }
  for (int idx = tid; idx < TN * AK; idx += NT) {
    const int c = idx / AK, ak = idx - c * AK;
    const bool ok = a0 + ak < na;
    cp_async4(dsb + ak * DS + c, ok ? d + (size_t)(c0 + c) * na + a0 + ak : d,
              ok);
  }
  cp_async_commit();
}

// BF16: round the entries this thread staged, once its copies landed.
__device__ __forceinline__ void round_chunk(float* qsb, float* dsb, int tid) {
  for (int idx = tid; idx < TQ * AK; idx += NT) qsb[idx] = to_bf16_rne(qsb[idx]);
  for (int idx = tid; idx < TN * AK; idx += NT) {
    const int c = idx / AK, ak = idx - c * AK;
    dsb[ak * DS + c] = to_bf16_rne(dsb[ak * DS + c]);
  }
}

// acc[i][c] += q[i] * d[c] for one attribute: the RT query values at qt
// and the CT data values at dt, both read as float4s.
__device__ __forceinline__ void fma_step(float (&acc)[RT][CT], const float* qt,
                                         const float* dt) {
  const float4 dv = *reinterpret_cast<const float4*>(dt);
  const float4 qa = *reinterpret_cast<const float4*>(qt);
  const float4 qb = *reinterpret_cast<const float4*>(qt + 4);
  const float qv[RT] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
  const float dw[CT] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(qv[i], dw[c], acc[i][c]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// An unsigned key that orders as the float does (-0.0 folded to +0.0).
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_dist(u64 k) {
  return __uint_as_float((unsigned)(k >> 32));
}

// Ascending bitonic sort of one key per lane over lanes [0, m), m a power
// of two up to 32 (the lanes past m hold equal padding keys).
__device__ __forceinline__ u64 warp_sort(u64 key, int m, int lane) {
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(FULL, key, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      key = keep_min ? (o < key ? o : key) : (o > key ? o : key);
    }
  }
  return key;
}

// Ascending bitonic sort of n (a power of two) keys in shared memory by
// one warp.
__device__ void warp_sort_shared(u64* k, int n, int lane) {
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const u64 a = k[lo], c = k[hi];
        if ((a > c) == ((lo & size) == 0)) {
          k[lo] = c;
          k[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

// #(entries of the sorted L[0, n) that are <= x).
__device__ __forceinline__ int count_le(const float* L, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (L[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #(keys of the sorted K[0, n) whose distance is < x).
__device__ __forceinline__ int count_lt(const u64* K, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_dist(K[mid]) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// merge_row for n <= 32 candidates sorted in registers (candidate i's key
// in lane i): p_i = #(list entries <= c_i) is candidate i's slot less i,
// and a list entry j moves by #(candidates < L[j]) = #(i : p_i <= j), which
// each lane counts from the p_i broadcast by shuffles: no search per entry.
__device__ __forceinline__ void merge_row_small(float* L, int* I, u64 key,
                                                int n, int kc, int lane,
                                                int idb) {
  const float c = key_dist(key);
  const int p = lane < n ? count_le(L, kc, c) : kc;
  const int u = __shfl_sync(FULL, p, 0);
  int sh[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) sh[t] = 0;
  for (int i = 0; i < n; ++i) {
    const int pi = __shfl_sync(FULL, p, i);
#pragma unroll
    for (int t = 0; t < KPL; ++t) sh[t] += pi <= u + lane + 32 * t;
  }
  float lv[KPL];
  int lid[KPL], lnew[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = u + lane + 32 * t;
    lnew[t] = j < kc ? j + sh[t] : kc;
    if (lnew[t] < kc) {
      lv[t] = L[j];
      lid[t] = I[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    if (lnew[t] < kc) {
      L[lnew[t]] = lv[t];
      I[lnew[t]] = lid[t];
    }
  }
  if (lane < n && lane + p < kc) {
    L[lane + p] = c;
    I[lane + p] = idb + (int)(key & 0xffffffffu);
  }
  __syncwarp();
}

// Merge the n sorted candidate keys K (distance bits, tile position) into
// the row's sorted list (L, I) of kc entries, in place, by rank: a list
// entry j goes to j + #(candidates < it), candidate i to i + #(list
// entries <= it); ranks >= kc drop. Entries at or below the smallest
// candidate keep their slots. Ids are idb + position.
__device__ __forceinline__ void merge_row(float* L, int* I, const u64* K,
                                          int n, int kc, int lane, int idb) {
  const int u = count_le(L, kc, key_dist(K[0]));
  float lv[KPL];
  int lid[KPL], lnew[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = u + lane + 32 * t;
    lnew[t] = kc;
    if (j < kc) {
      lv[t] = L[j];
      lid[t] = I[j];
      lnew[t] = j + count_lt(K, n, lv[t]);
    }
  }
  int cnew[VPL];
#pragma unroll
  for (int t = 0; t < VPL; ++t) {
    const int i = lane + 32 * t;
    cnew[t] = kc;
    if (i < n) cnew[t] = i + u + count_le(L + u, kc - u, key_dist(K[i]));
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    if (lnew[t] < kc) {
      L[lnew[t]] = lv[t];
      I[lnew[t]] = lid[t];
    }
  }
#pragma unroll
  for (int t = 0; t < VPL; ++t) {
    if (cnew[t] < kc) {
      const u64 k = K[lane + 32 * t];
      L[cnew[t]] = key_dist(k);
      I[cnew[t]] = idb + (int)(k & 0xffffffffu);
    }
  }
  __syncwarp();
}

// Block-wide min / max / max over one value per thread (NT threads).
__device__ __forceinline__ void block_range(float mn, float mx, float hi,
                                            float (*red)[NW], float& omn,
                                            float& omx, float& ohi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
    red[2][warp] = hi;
  }
  __syncthreads();
  omn = red[0][0];
  omx = red[1][0];
  ohi = red[2][0];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    omn = fminf(omn, red[0][w]);
    omx = fmaxf(omx, red[1][w]);
    ohi = fmaxf(ohi, red[2][w]);
  }
  __syncthreads();  // red is reused by the next block
}

template <bool MXU_GATE, bool BLOCK_SKIP, bool BF16>
__global__ void __launch_bounds__(NT, 2)
extract_topk_kernel(const float* __restrict__ q, const float* __restrict__ d,
                    const float* __restrict__ qn, const float* __restrict__ dn,
                    const float* __restrict__ floor_, const float* __restrict__ cd,
                    const int* __restrict__ ci, float* __restrict__ od,
                    int* __restrict__ oi, int* __restrict__ iters, int qb, int b,
                    int na, int kc, int n_real, int id_base, float eps_rel,
                    float eps_coef) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* ck = reinterpret_cast<u64*>(smem_raw);  // [NW][TN] candidate keys
  float* dist = reinterpret_cast<float*>(ck + NW * TN);  // [TQ][TN]
  float* qs = dist + TQ * TN;             // [2][AK][TQ]
  float* ds = qs + 2 * AK * TQ;           // [2][AK][DS]
  float* tcur = ds + 2 * AK * DS;         // [TQ] thresholds: L[kc - 1]
  float* qn_s = tcur + TQ;                // [TQ]
  float* fl_s = qn_s + TQ;                // [TQ]
  float* ld = fl_s + TQ;                  // [TQ][kc] list distances, sorted
  int* li = reinterpret_cast<int*>(ld + TQ * kc);  // [TQ][kc] list ids
  __shared__ float red[3][NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TQ;
  const int nrows = min(TQ, qb - row0);
  const int nblk = b / TN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int j0 = (int)((long long)split * nblk / splits);
  const int j1 = (int)((long long)(split + 1) * nblk / splits);
  const bool seed = splits == 1 && cd != nullptr;
  od += (size_t)split * qb * kc;
  oi += (size_t)split * qb * kc;

  for (int r = tid; r < TQ; r += NT) {
    qn_s[r] = r < nrows ? qn[row0 + r] : 0.f;
    fl_s[r] = (r < nrows && floor_ != nullptr) ? floor_[row0 + r] : -INFINITY;
  }
  if (seed) {
    // Each warp sorts its rows of the carry by (distance, slot), stably,
    // in its KC_MAX keys of the (still unused) distance tile.
    u64* keys = reinterpret_cast<u64*>(dist) + warp * KC_MAX;
    for (int r = warp; r < nrows; r += NW) {
      const float* crow = cd + (size_t)(row0 + r) * kc;
      const int* irow = ci + (size_t)(row0 + r) * kc;
      float* L = ld + r * kc;
      int* I = li + r * kc;
      int unsorted = 0;
      for (int c = lane; c + 1 < kc; c += 32)
        unsorted |= !(crow[c] <= crow[c + 1]);
      if (!__any_sync(FULL, unsorted)) {
        for (int c = lane; c < kc; c += 32) {
          L[c] = crow[c] + 0.0f;
          I[c] = irow[c];
        }
        continue;
      }
      int npad = 32;
      while (npad < kc) npad <<= 1;
      for (int e = lane; e < npad; e += 32)
        keys[e] = e < kc ? ((u64)float_key(crow[e]) << 32) | (unsigned)e
                         : ~0ull;
      warp_sort_shared(keys, npad, lane);
      for (int c = lane; c < kc; c += 32) {
        const int slot = (int)(keys[c] & 0xffffffffu);
        L[c] = crow[slot] + 0.0f;
        I[c] = irow[slot];
      }
      __syncwarp();
    }
  } else {
    // kc copies of (the carry's row maximum, -1) at S > 1, of (+inf, -1)
    // without a carry: sorted as they stand.
    for (int r = warp; r < nrows; r += NW) {
      float cmax = INFINITY;
      if (cd != nullptr) {
        float m = -INFINITY;
        for (int c = lane; c < kc; c += 32)
          m = fmaxf(m, cd[(size_t)(row0 + r) * kc + c]);
        cmax = warp_max(m) + 0.0f;
      }
      for (int c = lane; c < kc; c += 32) {
        ld[r * kc + c] = cmax;
        li[r * kc + c] = -1;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < TQ; r += NT)
    tcur[r] = r < nrows ? ld[r * kc + kc - 1] : INFINITY;
  __syncthreads();

  const int nch = (na + AK - 1) / AK;
  int staged = -1;  // the block whose first chunk is in (or bound for) buffer 0
  for (int j = j0; j < j1; ++j) {
    const int c0 = j * TN;
    if (MXU_GATE) {
      const bool real = c0 + tid < n_real;  // this thread's column
      const float dnv = dn[c0 + tid];
      // Norm-bound gate: |q - d|^2 >= (|q| - |d|)^2 over the block's real
      // |d| range, deflated by the f32 error bound. An all-sentinel block
      // gives inf - inf = NaN, which skips (the Pallas kernel relies on
      // NaN propagating through jnp.maximum; fmaxf would drop it).
      const float sdn = sqrtf(fmaxf(dnv, 0.f));
      float mn, mx, hi;
      block_range(real ? sdn : INFINITY, real ? sdn : -INFINITY,
                  real ? dnv : 0.f, red, mn, mx, hi);
      int pass = 0;
      if (tid < nrows) {
        const float qv = qn_s[tid];
        const float sq = sqrtf(fmaxf(qv, 0.f));
        const float gap = fmaxf(fmaxf(mn - sq, sq - mx), 0.f);
        // Rounded intrinsics: no FMA contraction, so the predicate is
        // bit-identical to the plain PyTorch version's.
        const float lb = __fmul_rn(gap, gap);
        const float scale = __fadd_rn(fmaxf(qv, 0.f), hi);
        const float eps = __fadd_rn(__fmul_rn(eps_rel, sqrtf(__fmul_rn(lb, scale))),
                                    __fmul_rn(eps_coef, scale));
        const float lbs = __fsub_rn(lb, eps);
        pass = !isnan(lbs) && fmaxf(lbs, 0.f) < tcur[tid];
      }
      if (!__syncthreads_or(pass)) {
        if (tid == 0) iters[blockIdx.x * nblk + j] = 0;
        continue;
      }
    }

    // Distance tile on the FP32 pipes. Chunk k + 1 is copied while chunk
    // k's FMAs run; the first chunk was started during the previous
    // block's extraction unless the gate skipped the block it was for.
    if (staged != j) {
      cp_async_wait<0>();  // a copy for a skipped block still lands first
      stage_chunk(qs, ds, q, d, row0, nrows, c0, na, 0, tid);
    }
    // Thread t computes rows [RT*rg, RT*rg + RT) x columns [CT*cg, CT*cg
    // + CT) of the tile (rg = t / 64 is one per warp, so the q reads are
    // broadcasts): per attribute 3 float4 shared loads feed 32 FMAs.
    const int rg = tid / (TN / CT), cg = tid % (TN / CT);
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
    for (int k = 0; k < nch; ++k) {
      const int ak_n = min(AK, na - k * AK);
      float* qsb = qs + (k & 1) * AK * TQ;
      float* dsb = ds + (k & 1) * AK * DS;
      if (k + 1 < nch) {
        stage_chunk(qs + ((k + 1) & 1) * AK * TQ, ds + ((k + 1) & 1) * AK * DS,
                    q, d, row0, nrows, c0, na, (k + 1) * AK, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if (BF16) round_chunk(qsb, dsb, tid);
      __syncthreads();
      const float* qt = qsb + RT * rg;
      const float* dt = dsb + CT * cg;
      if (ak_n == AK) {  // a whole chunk, unrolled so that loads run ahead
#pragma unroll
        for (int ak = 0; ak < AK; ++ak) fma_step(acc, qt + ak * TQ, dt + ak * DS);
      } else {
        for (int ak = 0; ak < ak_n; ++ak) fma_step(acc, qt + ak * TQ, dt + ak * DS);
      }
      __syncthreads();  // this buffer is staged again two chunks on
    }
    if (j + 1 < j1) {
      stage_chunk(qs, ds, q, d, row0, nrows, c0 + TN, na, 0, tid);
      staged = j + 1;
    }
    float dnc[CT];
    bool realc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      dnc[c] = dn[c0 + CT * cg + c];
      realc[c] = c0 + CT * cg + c < n_real;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = RT * rg + i;
      float v[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        v[c] = fmaxf(qn_s[r] + dnc[c] - 2.f * acc[i][c], 0.f);
        if (v[c] < fl_s[r] || !realc[c]) v[c] = INFINITY;
      }
      *reinterpret_cast<float4*>(dist + r * TN + CT * cg) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    // One warp per row: ballot the candidates below T, sort and merge.
    int any = 0;
    u64* K = ck + warp * TN;
    for (int r = warp; r < nrows; r += NW) {
      const float t = tcur[r];
      float v[VPL];
      unsigned m[VPL];
      int n = 0;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        v[k] = dist[r * TN + lane + 32 * k] + 0.0f;
        m[k] = __ballot_sync(FULL, v[k] < t);
        n += __popc(m[k]);
      }
      if (n == 0) continue;
      any = 1;
      const unsigned below = (1u << lane) - 1u;
      int base = 0;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        if ((m[k] >> lane) & 1u)
          K[base + __popc(m[k] & below)] =
              ((u64)__float_as_uint(v[k]) << 32) | (unsigned)(lane + 32 * k);
        base += __popc(m[k]);
      }
      __syncwarp();
      float* L = ld + r * kc;
      int npad = 1;
      while (npad < n) npad <<= 1;
      if (n <= 32) {
        const u64 key = warp_sort(lane < n ? K[lane] : ~0ull, npad, lane);
        merge_row_small(L, li + r * kc, key, n, kc, lane, id_base + c0);
      } else {
        for (int e = n + lane; e < npad; e += 32) K[e] = ~0ull;
        warp_sort_shared(K, npad, lane);
        merge_row(L, li + r * kc, K, n, kc, lane, id_base + c0);
      }
      if (lane == 0) tcur[r] = L[kc - 1];
    }
    const int proc = __syncthreads_or(any);
    if (tid == 0) iters[blockIdx.x * nblk + j] = BLOCK_SKIP ? proc : 1;
  }
  cp_async_wait<0>();

  for (int idx = tid; idx < nrows * kc; idx += NT) {
    od[(size_t)row0 * kc + idx] = ld[idx];
    oi[(size_t)row0 * kc + idx] = li[idx];
  }
}

// One CTA per row: the exact top-kc of carry ++ partial_0 ++ ... ++
// partial_{S-1} by (distance asc, carry before block, then carry slot asc
// for carry entries and id asc for partial ones), sorted.
// npad is the entry count rounded up to a power of two; the padding keys
// are all ones and sort last.
__global__ void __launch_bounds__(MT)
extract_merge_kernel(const float* __restrict__ cd, const int* __restrict__ ci,
                     const float* __restrict__ pd, const int* __restrict__ pi,
                     float* __restrict__ od, int* __restrict__ oi, int qb,
                     int kc, int splits, int npad) {
  extern __shared__ unsigned long long keys[];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int nc = cd != nullptr ? kc : 0;
  const int n = nc + splits * kc;
  for (int e = tid; e < npad; e += MT) {
    unsigned long long key = ~0ull;
    if (e < n) {
      float v;
      unsigned low;
      unsigned long long flag;
      if (e < nc) {
        v = cd[(size_t)row * kc + e];
        low = (unsigned)e;
        flag = 0;
      } else {
        const int p = e - nc, s = p / kc, c = p - s * kc;
        const size_t at = ((size_t)s * qb + row) * kc + c;
        v = pd[at];
        low = (unsigned)(pi[at] + 1);
        flag = 1;
      }
      key = ((unsigned long long)__float_as_uint(v + 0.0f) << 32) |
            (flag << 31) | (unsigned long long)low;
    }
    keys[e] = key;
  }
  __syncthreads();
  for (int size = 2; size <= npad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < npad / 2; t += MT) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const unsigned long long a = keys[lo], c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int c = tid; c < kc; c += MT) {
    const unsigned long long key = keys[c];
    const int low = (int)(key & 0x7fffffffull);
    od[(size_t)row * kc + c] = __uint_as_float((unsigned)(key >> 32));
    oi[(size_t)row * kc + c] =
        (key >> 31) & 1ull ? low - 1 : ci[(size_t)row * kc + low];
  }
}

size_t smem_bytes(int kc) {
  return sizeof(u64) * (size_t)NW * TN +
         sizeof(float) * ((size_t)TQ * TN + 2 * (size_t)AK * TQ +
                          2 * (size_t)AK * DS + 3 * (size_t)TQ) +
         (sizeof(float) + sizeof(int)) * (size_t)TQ * kc;
}

template <bool G, bool S, bool H>
int launch(const float* q, const float* d, const float* qn, const float* dn,
           const float* fl, const float* cd, const int* ci, float* od, int* oi,
           int* iters, int qb, int b, int na, int kc, int n_real, int id_base,
           int splits, float eps_rel, float eps_coef, cudaStream_t stream) {
  const size_t smem = smem_bytes(kc);
  cudaError_t e = cudaFuncSetAttribute(
      extract_topk_kernel<G, S, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((qb + TQ - 1) / TQ, splits);
  extract_topk_kernel<G, S, H><<<grid, NT, smem, stream>>>(
      q, d, qn, dn, fl, cd, ci, od, oi, iters, qb, b, na, kc, n_real, id_base,
      eps_rel, eps_coef);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile constants, so the Python side can check that it sizes outputs and
// budgets shared memory for the kernel it loaded.
int dmlp_extract_tile_q() { return TQ; }
int dmlp_extract_tile_n() { return TN; }
int dmlp_extract_merge_max() { return MERGE_MAX; }
long long dmlp_extract_smem_bytes(int kc) { return (long long)smem_bytes(kc); }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// floor_, cd and ci may be null (no floor / no carry). b % TN == 0,
// 1 <= kc <= KC_MAX and 1 <= splits <= b / TN. At splits > 1, od and oi
// are the (splits, qb, kc) partial-list scratch that dmlp_extract_merge
// reads.
int dmlp_extract_topk(const float* q, const float* d, const float* qn,
                      const float* dn, const float* floor_, const float* cd,
                      const int* ci, float* od, int* oi, int* iters, int qb,
                      int b, int na, int kc, int n_real, int id_base,
                      int splits, int mxu_gate, int block_skip, int bf16,
                      float eps_rel, float eps_coef, void* stream) {
  if (qb <= 0 || b <= 0 || b % TN != 0 || na <= 0 || kc <= 0 ||
      kc > KC_MAX || splits < 1 || splits > b / TN || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DMLP_LAUNCH(G, S, H)                                                   \
  return launch<G, S, H>(q, d, qn, dn, floor_, cd, ci, od, oi, iters, qb, b,  \
                         na, kc, n_real, id_base, splits, eps_rel, eps_coef, s)
  const int key = (mxu_gate ? 4 : 0) | (block_skip ? 2 : 0) | (bf16 ? 1 : 0);
  switch (key) {
    case 0: DMLP_LAUNCH(false, false, false);
    case 1: DMLP_LAUNCH(false, false, true);
    case 2: DMLP_LAUNCH(false, true, false);
    case 3: DMLP_LAUNCH(false, true, true);
    case 4: DMLP_LAUNCH(true, false, false);
    case 5: DMLP_LAUNCH(true, false, true);
    case 6: DMLP_LAUNCH(true, true, false);
    default: DMLP_LAUNCH(true, true, true);
  }
#undef DMLP_LAUNCH
}

// Merge the (splits, qb, kc) partial lists pd/pi with the optional carry
// cd/ci into the sorted (qb, kc) lists od/oi, on `stream`; returns the
// cudaError_t of the launch. (1 + splits) * kc <= MERGE_MAX.
int dmlp_extract_merge(const float* cd, const int* ci, const float* pd,
                       const int* pi, float* od, int* oi, int qb, int kc,
                       int splits, void* stream) {
  if (qb <= 0 || kc <= 0 || splits < 1 || (1 + splits) * kc > MERGE_MAX)
    return (int)cudaErrorInvalidValue;
  const int n = (cd != nullptr ? kc : 0) + splits * kc;
  int npad = 2;
  while (npad < n) npad <<= 1;
  const size_t smem = sizeof(unsigned long long) * (size_t)npad;
  cudaError_t e = cudaFuncSetAttribute(
      extract_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(unsigned long long) * MERGE_MAX));
  if (e != cudaSuccess) return (int)e;
  extract_merge_kernel<<<qb, MT, smem, static_cast<cudaStream_t>(stream)>>>(
      cd, ci, pd, pi, od, oi, qb, kc, splits, npad);
  return (int)cudaGetLastError();
}

}  // extern "C"
