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
// The merge (extract_merge_kernel) takes the exact top-kc of carry ++
// partials. Each entry is a 64-bit key: the distance as an order-keeping
// unsigned (-0.0 folded to +0.0), then a carry/block flag, then the slot
// for a carry entry and id + 1 for a partial one. The keys order totally
// (only seeds and (+inf, -1) padding repeat, and equal keys write equal
// outputs), so any pairing of the lists gives the stable sort's first kc.
// Carry entries keep the order S = 1 gives them (sorted by (distance,
// slot)), not the order of their ids: a carry folded from a later chunk
// than the block, as the serving engine's hot-chunks-first order folds,
// holds tie groups whose ids do not ascend in slot order, and ordering
// them by id would evict other members of a tie group at the boundary than
// S = 1 does. The split kernel's partial lists are its sorted shared-memory
// lists, already in key order: distance ascending, seeds ahead of real
// entries at their distance (list entries win ties, and a seed's key has
// low = 0), earlier blocks and positions (lower ids) first. So the merge
// does not sort: a CTA loads R rows' 1 + S lists into shared memory once
// (16-byte loads where kc % 4 == 0) and checks each list's order in
// registers as it loads it (adjacent compares, the next group's first key
// from the next lane; one __syncthreads_or). Only where a list is out of
// order (a carry a caller hands in unsorted) does it flag the lists in
// shared memory and sort them in place (a bitonic network, log2(kc) *
// (log2(kc) + 1) / 2 barriers). Then it merges pairs of lists in
// ceil(log2(1 + S)) rounds, one barrier each, keeping the first kc of each
// pair (an odd list passes through). In a round each thread owns a run of
// output positions of one pair: it finds the run's start by a merge-path
// binary search on the diagonal and merges sequentially, both taking the
// first list's key on equal keys. The last round writes the distance from
// the key and the id (id + 1 less one, or ci[row, slot]). R rows share a
// CTA where (1 + S) * kc is small, so that every CTA holds about
// MERGE_KEYS keys; the index divisions are multiplications by reciprocals.
// It moves (1+S)*Qb*kc*8 bytes (carry, partials and outputs) and is bound
// by them in principle; on the card its time is the rounds' shared-memory
// work and, through the wrapper, the host's launch work (PERF.md, §6).

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
constexpr int MERGE_MAX = 8192; // entries one merge row may hold ((1+S)*kc)
constexpr int MERGE_KEYS = 2048;  // keys a merge CTA holds where rows are small
constexpr int MERGE_NT_MAX = 1024;  // threads of the widest merge CTA
constexpr int MERGE_KEYS_PER_THREAD = 8;  // keys a merge thread loads
constexpr int MERGE_LOADS = 2;  // 16-byte loads a merge thread has in flight
constexpr unsigned FULL = 0xffffffffu;
// The seeding sort borrows the distance tile as NW x KC_MAX keys.
static_assert(sizeof(float) * TQ * TN >= sizeof(u64) * NW * KC_MAX,
              "the distance tile must hold the seeding sort's keys");

// The one rounding of the bf16 first pass; its error is lowp_eps's.
__device__ __forceinline__ float to_bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));  // check: lowp-eps=lowp_eps
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
  // check: lowp-eps=lowp_eps
  for (int idx = tid; idx < TQ * AK; idx += NT) qsb[idx] = to_bf16_rne(qsb[idx]);
  for (int idx = tid; idx < TN * AK; idx += NT) {
    const int c = idx / AK, ak = idx - c * AK;
    dsb[ak * DS + c] = to_bf16_rne(dsb[ak * DS + c]);  // check: lowp-eps=lowp_eps
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

// The order-keeping float of a float_key.
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ u64 merge_key(float v, unsigned flag,
                                         unsigned low) {
  return ((u64)float_key(v) << 32) | ((u64)flag << 31) | (u64)low;
}

// Output o of a merge round: into the next round's list D, or, in the last
// round, the distance and the id (id + 1 less one, or ci[row, slot]) of
// the row whose outputs start at orow.
__device__ __forceinline__ void merge_put(bool last, u64* D, int o, u64 x,
                                          float* od, int* oi, const int* ci,
                                          size_t orow) {
  if (!last) {
    D[o] = x;
    return;
  }
  const unsigned low = (unsigned)(x & 0x7fffffffull);
  od[orow + o] = key_float((unsigned)(x >> 32));
  oi[orow + o] = (x >> 31) & 1ull ? (int)low - 1 : ci[orow + low];
}

// x / d for the d that m = merge_magic(d) stands for, exact while x * d <
// 2^32 (the merge's indices stay under 2^14 and its divisors under 2^14).
__host__ __device__ __forceinline__ u64 merge_magic(unsigned d) {
  return ((1ull << 32) + d - 1) / d;
}

__device__ __forceinline__ int merge_div(int x, u64 m) {
  return (int)(((u64)(unsigned)x * m) >> 32);
}

// Rows [row0, row0 + nrows) of the merge, rows_per_cta rows a CTA, each
// with nl = carry + splits lists of kc entries: the exact top-kc of carry
// ++ partial_0 ++ ... ++ partial_{S-1} by (distance asc, carry before
// block, then carry slot asc for carry entries and id asc for partial
// ones), sorted. Shared memory: the rows' nl lists of keys, the first
// round's ceil(nl / 2) lists, and a flag per list; the rounds keep each
// buffer's lists packed (list p of row r at r * lists + p). VEC: kc % 4 ==
// 0 and 16-byte aligned inputs. mn and mkc are merge_magic(nl * kc) and
// merge_magic(kc).
template <bool VEC>
__global__ void __launch_bounds__(MERGE_NT_MAX, 1)
extract_merge_kernel(const float* __restrict__ cd, const int* __restrict__ ci,
                     const float* __restrict__ pd, const int* __restrict__ pi,
                     float* __restrict__ od, int* __restrict__ oi, int qb,
                     int kc, int splits, int rows_per_cta, u64 mn, u64 mkc) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ u64 round_magic[16];  // merge_magic of each round's list count
  const int nc = cd != nullptr ? 1 : 0;
  const int nl = nc + splits;  // lists a row
  const int n = nl * kc;       // keys a row
  const int row0 = blockIdx.x * rows_per_cta;
  const int nrows = min(rows_per_cta, qb - row0);
  const int total = nrows * n;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  u64* src = reinterpret_cast<u64*>(merge_smem);
  u64* dst = src + (size_t)rows_per_cta * n;
  int* unsorted = reinterpret_cast<int*>(
      dst + (size_t)rows_per_cta * ((nl + 1) >> 1) * kc);

  if (tid < 16) {
    int outl = nl;
    for (int i = 0; i <= tid; ++i) outl = (outl + 1) >> 1;
    round_magic[tid] = merge_magic(outl);
  }
  // Key e of the CTA is row e / n, list (e % n) / kc, entry e % kc. With
  // VEC a thread issues the loads of MERGE_LOADS groups of 4 keys before
  // it stores any, so that they are in flight together, and checks the
  // order of its keys in registers: within a group, and against the next
  // group's first key (the next lane's, or for lane 31 one more load).
  // Without VEC every list is checked in shared memory below.
  int found = !VEC;
  if (VEC) {
    // The lanes of a warp take the loop together (the shuffle needs them
    // all): it runs while the warp's first group is in range.
    const int ng = total / 4;
    for (int g0 = tid; g0 - lane < ng; g0 += MERGE_LOADS * nth) {
      float4 v[MERGE_LOADS];
      int4 low[MERGE_LOADS];
      float nv[MERGE_LOADS];  // lane 31: the next group's first entry
      int nlow[MERGE_LOADS];
      bool part[MERGE_LOADS], more[MERGE_LOADS];
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u) {
        const int e = 4 * (g0 + u * nth), r = merge_div(e, mn);
        const int l = merge_div(e - r * n, mkc), c = e - r * n - l * kc;
        part[u] = l >= nc;
        more[u] = e < total && c + 4 < kc;  // the next group is this list's
        if (e >= total) continue;
        if (!part[u]) {
          const float* at = cd + (size_t)(row0 + r) * kc + c;
          v[u] = *reinterpret_cast<const float4*>(at);
          low[u] = make_int4(c, c + 1, c + 2, c + 3);
          if (lane == 31 && more[u]) {
            nv[u] = at[4];
            nlow[u] = c + 4;
          }
        } else {
          const size_t at = ((size_t)(l - nc) * qb + row0 + r) * kc + c;
          v[u] = *reinterpret_cast<const float4*>(pd + at);
          const int4 id = *reinterpret_cast<const int4*>(pi + at);
          low[u] = make_int4(id.x + 1, id.y + 1, id.z + 1, id.w + 1);
          if (lane == 31 && more[u]) {
            nv[u] = pd[at + 4];
            nlow[u] = pi[at + 4] + 1;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u) {
        const int e = 4 * (g0 + u * nth);
        const bool ok = e < total;
        const unsigned f = part[u] ? 1u : 0u;
        u64 k[4] = {0, 0, 0, 0};
        if (ok) {
          k[0] = merge_key(v[u].x, f, (unsigned)low[u].x);
          k[1] = merge_key(v[u].y, f, (unsigned)low[u].y);
          k[2] = merge_key(v[u].z, f, (unsigned)low[u].z);
          k[3] = merge_key(v[u].w, f, (unsigned)low[u].w);
        }
        u64 next = __shfl_down_sync(FULL, k[0], 1);
        if (!ok) continue;
        if (lane == 31 && more[u]) next = merge_key(nv[u], f, (unsigned)nlow[u]);
        found |= k[0] > k[1] || k[1] > k[2] || k[2] > k[3] ||
                 (more[u] && k[3] > next);
        ulonglong2* s2 = reinterpret_cast<ulonglong2*>(src + e);
        s2[0] = make_ulonglong2(k[0], k[1]);
        s2[1] = make_ulonglong2(k[2], k[3]);
      }
    }
  } else {
    for (int e = tid; e < total; e += nth) {
      const int r = merge_div(e, mn), l = merge_div(e - r * n, mkc);
      const int c = e - r * n - l * kc;
      if (l < nc) {
        src[e] = merge_key(cd[(size_t)(row0 + r) * kc + c], 0, c);
      } else {
        const size_t at = ((size_t)(l - nc) * qb + row0 + r) * kc + c;
        src[e] = merge_key(pd[at], 1, (unsigned)(pi[at] + 1));
      }
    }
  }

  if (__syncthreads_or(found)) {
    // Flag each list out of order (a warp a list, a ballot per 32
    // entries), then sort the flagged lists in place: a bitonic network
    // whose first step at each size pairs mirrored entries, so that every
    // comparator puts the smaller key low; positions kc .. npad - 1 then
    // act as +inf padding that no comparator moves, and are never stored.
    int any = 0;
    for (int list = warp; list < nrows * nl; list += nwarps) {
      const u64* L = src + (size_t)list * kc;
      int bad = 0;
      for (int c = lane; c + 1 < kc; c += 32) bad |= L[c] > L[c + 1];
      bad = __any_sync(FULL, bad);
      if (lane == 0) unsorted[list] = bad;
      any |= bad;
    }
    if (__syncthreads_or(any)) {
      int lgh = 0;
      while ((2 << lgh) < kc) ++lgh;
      const int half = 1 << lgh;
      for (int size = 2; size <= 2 * half; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = tid; t < nrows * nl * half; t += nth) {
            const int list = t >> lgh, i = t & (half - 1);
            if (!unsorted[list]) continue;
            int lo, hi;
            if (stride == size >> 1) {
              const int blk = i / stride, j = i - blk * stride;
              lo = blk * size + j;
              hi = blk * size + size - 1 - j;
            } else {
              lo = 2 * i - (i & (stride - 1));
              hi = lo + stride;
            }
            if (hi < kc) {
              u64* L = src + (size_t)list * kc;
              const u64 x = L[lo], y = L[hi];
              if (x > y) {
                L[lo] = y;
                L[hi] = x;
              }
            }
          }
          __syncthreads();
        }
      }
    }
  }

  // The truncated merge tree: per round, list p of a row is the first kc
  // of lists 2p and 2p + 1 (list 2p alone when it has no partner).
  for (int lists = nl, round = 0;; ++round) {
    const int outl = (lists + 1) >> 1, odd = lists & 1;
    const bool last = outl == 1;
    // Each output list is cut into `runs` (a power of two) runs of `run`
    // positions, one a thread.
    int lg = 0;
    while ((2 << lg) <= kc && (nrows * outl) << (lg + 1) <= nth) ++lg;
    const int run = (kc + (1 << lg) - 1) >> lg;
    for (int t = tid; t < (nrows * outl) << lg; t += nth) {
      const int rp = t >> lg;  // = r * outl + p
      const int o0 = (t & ((1 << lg) - 1)) * run, cnt = min(run, kc - o0);
      if (cnt <= 0) continue;
      const int r = nrows == 1 ? 0 : merge_div(rp, round_magic[round]);
      const int p = rp - r * outl;
      const u64* A = src + (size_t)(2 * rp - r * odd) * kc;
      u64* D = dst + (size_t)rp * kc;
      const size_t orow = (size_t)(row0 + r) * kc;
      if (odd && p == outl - 1) {
        for (int k = 0; k < cnt; ++k)
          merge_put(last, D, o0 + k, A[o0 + k], od, oi, ci, orow);
        continue;
      }
      const u64* B = A + kc;
      // Merge path: a = #(A's keys among the first o0 outputs), A first
      // on equal keys. Every a, b below stays under kc: a + b < kc.
      int lo = 0, hi = o0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (A[mid] <= B[o0 - 1 - mid]) lo = mid + 1; else hi = mid;
      }
      int a = lo, b = o0 - lo;
      u64 va = A[a], vb = B[b];
      for (int k = 0; k < cnt; ++k) {
        const bool ta = va <= vb;
        merge_put(last, D, o0 + k, ta ? va : vb, od, oi, ci, orow);
        if (k + 1 < cnt) {
          if (ta) va = A[++a]; else vb = B[++b];
        }
      }
    }
    if (last) break;
    u64* t = src;
    src = dst;
    dst = t;
    lists = outl;
    __syncthreads();
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
  const int nl = (cd != nullptr ? 1 : 0) + splits;
  const int rows = max(1, min(MERGE_KEYS / (nl * kc), qb));
  const int keys = rows * nl * kc;
  const int nt = min(MERGE_NT_MAX,
                     max(128, (keys / MERGE_KEYS_PER_THREAD + 31) / 32 * 32));
  const size_t smem = sizeof(u64) * ((size_t)keys +
                                     (size_t)rows * ((nl + 1) / 2) * kc) +
                      sizeof(int) * (size_t)rows * nl;
  // The most any launch takes (rows * nl * kc <= MERGE_MAX), set once per
  // device.
  static bool attr_set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const int most = (int)((2 * sizeof(u64) + sizeof(int)) * MERGE_MAX);
    e = cudaFuncSetAttribute(extract_merge_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(extract_merge_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  const bool vec = kc % 4 == 0 &&
                   (((uintptr_t)pd | (uintptr_t)pi | (uintptr_t)cd) & 15) == 0;
  const dim3 grid((qb + rows - 1) / rows);
  const u64 mn = merge_magic(nl * kc), mkc = merge_magic(kc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    extract_merge_kernel<true><<<grid, nt, smem, s>>>(
        cd, ci, pd, pi, od, oi, qb, kc, splits, rows, mn, mkc);
  else
    extract_merge_kernel<false><<<grid, nt, smem, s>>>(
        cd, ci, pd, pi, od, oi, qb, kc, splits, rows, mn, mkc);
  return (int)cudaGetLastError();
}

}  // extern "C"
