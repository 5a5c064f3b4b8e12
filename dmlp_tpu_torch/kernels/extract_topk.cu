// Fused distance + running top-kc by threshold insertion, for Hopper (sm_90a).
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
//   extracted first, and the slot evicted is the one holding T with the
//   largest id, so carry entries and earlier positions win ties. At S > 1
//   the merge keeps the same rule: (distance asc, carry first, id asc).
//   iters[i, j] = 1 when query tile i processed data block j, 0 when the
//   norm gate or the block-min prefilter skipped it.
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
// kc entries all sort before it. Per block:
//   1. (MXU_GATE) one block-wide reduction of the block's real |d| range
//      gives every row a lower bound (|q| - |d|)^2 deflated by the f32
//      error bound of engine/finalize.py; when no row's bound beats its
//      current k-th best the block is skipped before any product.
//   2. The (TQ x TN) distance tile is computed on the CUDA cores with IEEE
//      float32 FMAs (never TF32: the eps bounds hold only for full f32
//      products). Thread t owns column t and keeps TQ accumulators in
//      registers; attributes are staged through shared memory AK at a time,
//      the data chunk transposed with a padded stride (no bank conflicts),
//      the query chunk read as broadcast float4s. BF16 rounds both operands
//      to bfloat16 (round-to-nearest-even) and still accumulates in f32.
//   3. The masked tile goes to shared memory; (BLOCK_SKIP) one min per row
//      against its current threshold skips blocks that cannot insert.
//   4. One warp per row extracts: warp argmin over the row's remaining
//      columns (lowest position on ties), insert if strictly below T into
//      the slot holding T, recompute T by a warp reduction over the list.
//      The (TQ x kc) lists live in shared memory for the whole sweep.
//
// What bounds it on the card: the distance product, 2*Qb*B*A FLOP on the
// FP32 pipes (no tensor cores), against ~Qb*B*A*4/TQ bytes of data re-read
// per query tile from L2. The chunk's bytes are tiny next to that work, so
// the kernel is bound by operations; its FMA loop issues one shared load
// per 4 FMAs. With few query tiles (1,024 queries make 32 CTAs) the split
// of the data axis is what fills the 132 SMs. wgmma with a split-precision
// product and asynchronous (cp.async / TMA) staging are later work.
//
// The merge (extract_merge_kernel): one CTA per row packs carry ++ partials
// into 64-bit keys (distance bits, then a carry/block flag, then id + 1),
// bitonic-sorts them in shared memory and writes the first kc, sorted.
// Non-negative floats and +inf order as unsigned integers; -0.0 is folded
// to +0.0 first. It moves (1+S)*Qb*kc*8 bytes and is bound by them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 32;          // query rows per CTA
constexpr int TN = 256;         // data columns per block (= threads per CTA)
constexpr int NT = 256;         // threads per CTA
constexpr int NW = NT / 32;     // warps per CTA
constexpr int AK = 32;          // attributes staged per step
constexpr int DS = TN + 1;      // padded row stride of the transposed data chunk
constexpr int VPL = TN / 32;    // tile columns each lane holds during extraction
constexpr int MT = 256;         // threads per merge CTA
constexpr int MERGE_MAX = 8192; // entries one merge row may hold ((1+S)*kc)

__device__ __forceinline__ float to_bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Warp argmin over (value, position): smaller value, then lower position.
__device__ __forceinline__ void warp_argmin(float& m, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float om = __shfl_xor_sync(0xffffffffu, m, off);
    int op = __shfl_xor_sync(0xffffffffu, p, off);
    if (om < m || (om == m && op < p)) {
      m = om;
      p = op;
    }
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The row's current threshold T (largest distance in its list) and the
// slot to evict: among slots holding T, the largest id, then the lowest
// slot. Every lane returns the same (T, slot).
__device__ __forceinline__ void row_threshold(const float* L, const int* I,
                                              int kc, int lane, float& t,
                                              int& slot) {
  float bv = -INFINITY;
  int bi = INT32_MIN, bs = INT32_MAX;
  for (int s = lane; s < kc; s += 32) {
    float v = L[s];
    int id = I[s];
    if (v > bv || (v == bv && (id > bi || (id == bi && s < bs)))) {
      bv = v;
      bi = id;
      bs = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    int os = __shfl_xor_sync(0xffffffffu, bs, off);
    if (ov > bv || (ov == bv && (oi > bi || (oi == bi && os < bs)))) {
      bv = ov;
      bi = oi;
      bs = os;
    }
  }
  t = bv;
  slot = bs;
}

// Block-wide min / max / max over one value per thread (NT threads).
__device__ __forceinline__ void block_range(float mn, float mx, float hi,
                                            float (*red)[NW], float& omn,
                                            float& omx, float& ohi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
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
__global__ void __launch_bounds__(NT)
extract_topk_kernel(const float* __restrict__ q, const float* __restrict__ d,
                    const float* __restrict__ qn, const float* __restrict__ dn,
                    const float* __restrict__ floor_, const float* __restrict__ cd,
                    const int* __restrict__ ci, float* __restrict__ od,
                    int* __restrict__ oi, int* __restrict__ iters, int qb, int b,
                    int na, int kc, int n_real, int id_base, float eps_rel,
                    float eps_coef) {
  extern __shared__ float smem[];
  float* dist = smem;                     // [TQ][TN]
  float* qs = dist + TQ * TN;             // [AK][TQ]
  float* ds = qs + AK * TQ;               // [AK][DS]
  float* tcur = ds + AK * DS;             // [TQ] current thresholds
  float* qn_s = tcur + TQ;                // [TQ]
  float* fl_s = qn_s + TQ;                // [TQ]
  float* ld = fl_s + TQ;                  // [TQ][kc] list distances
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

  // S > 1: the carry's row maxima, the value the split lists start from.
  for (int r = warp; r < TQ; r += NW) {
    float cmax = INFINITY;
    if (!seed && cd != nullptr && r < nrows) {
      float m = -INFINITY;
      for (int c = lane; c < kc; c += 32)
        m = fmaxf(m, cd[(size_t)(row0 + r) * kc + c]);
      cmax = warp_max(m);
    }
    if (lane == 0) tcur[r] = cmax;
  }
  __syncthreads();
  for (int idx = tid; idx < TQ * kc; idx += NT) {
    const int r = idx / kc;
    float v = INFINITY;
    int id = -1;
    if (r < nrows) {
      v = seed ? cd[(size_t)row0 * kc + idx] : tcur[r];
      id = seed ? ci[(size_t)row0 * kc + idx] : -1;
    }
    ld[idx] = v;
    li[idx] = id;
  }
  for (int r = tid; r < TQ; r += NT) {
    qn_s[r] = r < nrows ? qn[row0 + r] : 0.f;
    fl_s[r] = (r < nrows && floor_ != nullptr) ? floor_[row0 + r] : -INFINITY;
  }
  __syncthreads();
  for (int r = warp; r < TQ; r += NW) {
    float t;
    int s;
    row_threshold(ld + r * kc, li + r * kc, kc, lane, t, s);
    if (lane == 0) tcur[r] = t;
  }
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const int c0 = j * TN;
    const int pos = c0 + tid;            // this thread's column
    const bool real = pos < n_real;
    const float dnv = dn[pos];

    if (MXU_GATE) {
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

    // Distance tile on the FP32 pipes.
    float acc[TQ];
#pragma unroll
    for (int r = 0; r < TQ; ++r) acc[r] = 0.f;
    for (int a0 = 0; a0 < na; a0 += AK) {
      const int ak_n = min(AK, na - a0);
      __syncthreads();  // previous chunk's readers are done
      for (int idx = tid; idx < TQ * AK; idx += NT) {
        const int ak = idx / TQ, r = idx - ak * TQ;
        float v = 0.f;
        if (r < nrows && ak < ak_n) v = q[(size_t)(row0 + r) * na + a0 + ak];
        qs[idx] = BF16 ? to_bf16_rne(v) : v;
      }
      for (int idx = tid; idx < TN * AK; idx += NT) {
        const int c = idx / AK, ak = idx - c * AK;
        float v = 0.f;
        if (ak < ak_n) v = d[(size_t)(c0 + c) * na + a0 + ak];
        ds[ak * DS + c] = BF16 ? to_bf16_rne(v) : v;
      }
      __syncthreads();
      for (int ak = 0; ak < ak_n; ++ak) {
        const float dv = ds[ak * DS + tid];
        const float4* qv = reinterpret_cast<const float4*>(qs + ak * TQ);
#pragma unroll
        for (int r4 = 0; r4 < TQ / 4; ++r4) {
          const float4 x = qv[r4];
          acc[4 * r4 + 0] = fmaf(x.x, dv, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(x.y, dv, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(x.z, dv, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(x.w, dv, acc[4 * r4 + 3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      float v = fmaxf(qn_s[r] + dnv - 2.f * acc[r], 0.f);
      if (v < fl_s[r] || !real) v = INFINITY;
      dist[r * TN + tid] = v;
    }
    __syncthreads();

    int proc = 1;
    if (BLOCK_SKIP) {
      int any = 0;
      for (int r = warp; r < nrows; r += NW) {
        float m = INFINITY;
#pragma unroll
        for (int k = 0; k < VPL; ++k) m = fminf(m, dist[r * TN + lane + 32 * k]);
        any |= warp_min(m) < tcur[r];
      }
      proc = __syncthreads_or(any);
    }
    if (tid == 0) iters[blockIdx.x * nblk + j] = proc;
    if (!proc) continue;

    for (int r = warp; r < nrows; r += NW) {
      float* L = ld + r * kc;
      int* I = li + r * kc;
      float v[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) v[k] = dist[r * TN + lane + 32 * k];
      float t;
      int slot;
      row_threshold(L, I, kc, lane, t, slot);
      while (true) {
        float m = INFINITY;
        int p = INT32_MAX;
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
          if (v[k] < m) {
            m = v[k];
            p = lane + 32 * k;
          }
        }
        warp_argmin(m, p);
        if (!(m < t)) break;
        if (lane == 0) {
          L[slot] = m;
          I[slot] = id_base + c0 + p;
        }
        if (lane == (p & 31)) {
#pragma unroll
          for (int k = 0; k < VPL; ++k)
            if (k == (p >> 5)) v[k] = INFINITY;
        }
        __syncwarp();
        row_threshold(L, I, kc, lane, t, slot);
      }
      if (lane == 0) tcur[r] = t;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * kc; idx += NT) {
    od[(size_t)row0 * kc + idx] = ld[idx];
    oi[(size_t)row0 * kc + idx] = li[idx];
  }
}

// One CTA per row: the exact top-kc of carry ++ partial_0 ++ ... ++
// partial_{S-1} by (distance asc, carry before block, id asc), sorted.
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
      int id;
      unsigned long long flag;
      if (e < nc) {
        v = cd[(size_t)row * kc + e];
        id = ci[(size_t)row * kc + e];
        flag = 0;
      } else {
        const int p = e - nc, s = p / kc, c = p - s * kc;
        const size_t at = ((size_t)s * qb + row) * kc + c;
        v = pd[at];
        id = pi[at];
        flag = 1;
      }
      key = ((unsigned long long)__float_as_uint(v + 0.0f) << 32) |
            (flag << 31) | (unsigned long long)(unsigned)(id + 1);
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
    od[(size_t)row * kc + c] = __uint_as_float((unsigned)(key >> 32));
    oi[(size_t)row * kc + c] = (int)(key & 0x7fffffffull) - 1;
  }
}

size_t smem_bytes(int kc) {
  return sizeof(float) * ((size_t)TQ * TN + (size_t)AK * TQ + (size_t)AK * DS +
                          3 * (size_t)TQ) +
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
// floor_, cd and ci may be null (no floor / no carry). b % TN == 0 and
// 1 <= splits <= b / TN. At splits > 1, od and oi are the (splits, qb, kc)
// partial-list scratch that dmlp_extract_merge reads.
int dmlp_extract_topk(const float* q, const float* d, const float* qn,
                      const float* dn, const float* floor_, const float* cd,
                      const int* ci, float* od, int* oi, int* iters, int qb,
                      int b, int na, int kc, int n_real, int id_base,
                      int splits, int mxu_gate, int block_skip, int bf16,
                      float eps_rel, float eps_coef, void* stream) {
  if (qb <= 0 || b <= 0 || b % TN != 0 || na <= 0 || kc <= 0 ||
      splits < 1 || splits > b / TN || splits > 65535)
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
