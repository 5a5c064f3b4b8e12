// Masked distance tile + per-128-column segment minima, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dmlp_tpu/ops/pallas_distance.py::_kernel
// (pallas_call at :122), reached through fused_dist_segmin (:93). It feeds
// the "seg" fold (ops/topk.py step_seg): the huge-k outlier queries of the
// heterogeneous-k router and every streaming fold with array ids under the
// hand-written kernels.
//
// Contract (the reference's function, not its block schedule):
//   dist[i, j]   = max((qn_i + dn_j) - 2 q_i.d_j, 0), +inf where ids[j] < 0;
//   segmin[i, s] = min over j in [128 s, 128 s + 128) of dist[i, j].
// The reference emits segmin transposed (a Mosaic tiling constraint); this
// kernel emits (Qb, B/128) directly. qn and dn are the f32 squared norms of
// the f32 rows; BF16 rounds only the product's operands to bfloat16
// (round-to-nearest-even) and still accumulates in f32.
//
// Design. One CTA of 256 threads (8 warps) owns a tile of TQ = 64 query rows
// by one whole 128-column segment, so every segment minimum is finished
// inside the CTA: no atomics, no second pass. Attributes are staged through
// shared memory AK = 32 at a time (q as [AK][TQ], read back as broadcast
// float4s; the data rows transposed with a padded stride, so neither side
// has bank conflicts). Warp w owns rows 8w..8w+7 and lane l owns columns
// l, l+32, l+64, l+96: an 8 x 4 register micro-tile of IEEE f32 FMAs (never
// TF32: the eps bounds of engine/finalize.py hold only for full f32
// products). The epilogue stores each row's 128 values as four coalesced
// 128-byte warp stores, then reduces the row's minimum by warp shuffles and
// stores it once. Ragged query tiles are masked; offsets are 64-bit.
//
// What bounds it on the card. At the router's outlier shape (5,624 x 50,176
// x 64) the product is 2 * 5624 * 50176 * 64 = 36.1 GFLOP, 0.54 ms at the
// 67 TFLOP/s FP32 peak, against 1.13 GB of distance tile written, 0.34 ms at
// 3.35 TB/s: operations bound it, closely followed by the store. The loop
// issues 3 shared loads per 32 FMAs. wgmma (3xTF32 or split-bf16), TMA
// staging and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;        // segment width = data columns per CTA
constexpr int TQ = 64;          // query rows per CTA
constexpr int NT = 256;         // threads per CTA
constexpr int NW = NT / 32;     // warps per CTA
constexpr int RPW = TQ / NW;    // rows per warp (register micro-tile rows)
constexpr int CPL = SEG / 32;   // columns per lane (micro-tile columns)
constexpr int AK = 32;          // attributes staged per step
constexpr int DS = SEG + 1;     // padded row stride of the transposed data

static_assert(RPW == 8, "each warp reads its rows as two float4s");

__device__ __forceinline__ float to_bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
dist_segmin_kernel(const float* __restrict__ q, const float* __restrict__ d,
                   const float* __restrict__ qn, const float* __restrict__ dn,
                   const int* __restrict__ ids, float* __restrict__ dist,
                   float* __restrict__ segmin, int qb, int b, int na) {
  __shared__ __align__(16) float qs[AK * TQ];   // [AK][TQ]
  __shared__ float ds[AK * DS];                 // [AK][DS]

  const int nseg = b / SEG;
  const int seg = blockIdx.x % nseg;
  const int row0 = (blockIdx.x / nseg) * TQ;
  const int c0 = seg * SEG;
  const int nrows = min(TQ, qb - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;

  for (int a0 = 0; a0 < na; a0 += AK) {
    const int ak_n = min(AK, na - a0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < AK * TQ; idx += NT) {
      const int ak = idx / TQ, r = idx - ak * TQ;
      float v = 0.f;
      if (r < nrows && ak < ak_n) v = q[(size_t)(row0 + r) * na + a0 + ak];
      qs[idx] = BF16 ? to_bf16_rne(v) : v;
    }
    for (int idx = tid; idx < SEG * AK; idx += NT) {
      const int c = idx / AK, ak = idx - c * AK;
      float v = 0.f;
      if (ak < ak_n) v = d[(size_t)(c0 + c) * na + a0 + ak];
      ds[ak * DS + c] = BF16 ? to_bf16_rne(v) : v;
    }
    __syncthreads();
    for (int ak = 0; ak < ak_n; ++ak) {
      const float4* qv = reinterpret_cast<const float4*>(qs + ak * TQ + warp * RPW);
      const float4 x0 = qv[0], x1 = qv[1];
      const float xr[RPW] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float dv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) dv[j] = ds[ak * DS + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(xr[i], dv[j], acc[i][j]);
    }
  }

  float dnv[CPL];
  bool sentinel[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = c0 + lane + 32 * j;
    dnv[j] = dn[col];
    sentinel[j] = ids[col] < 0;
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    if (r >= nrows) break;  // warp-uniform: the shuffles below stay full-warp
    const size_t row = (size_t)(row0 + r);
    const float qnv = qn[row];
    float m = INFINITY;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      // (qn + dn) first, as the reference sums; 2 * cross is exact, so a
      // contracted FMA gives the same rounding.
      const float s = qnv + dnv[j];
      float v = fmaxf(s - 2.f * acc[i][j], 0.f);
      if (sentinel[j]) v = INFINITY;
      dist[row * b + c0 + lane + 32 * j] = v;
      m = fminf(m, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) segmin[row * nseg + seg] = m;
  }
}

}  // namespace

extern "C" {

// Tile constants, so the Python side can check the kernel it loaded.
int dmlp_segmin_seg() { return SEG; }
int dmlp_segmin_tile_q() { return TQ; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q (qb, na), d (b, na) f32 row-major; qn (qb,), dn (b,) f32; ids (b,) i32;
// dist (qb, b) and segmin (qb, b / 128) f32 are written. b % 128 == 0.
int dmlp_dist_segmin(const float* q, const float* d, const float* qn,
                     const float* dn, const int* ids, float* dist,
                     float* segmin, int qb, int b, int na, int bf16,
                     void* stream) {
  if (qb <= 0 || b <= 0 || b % SEG != 0 || na <= 0)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)(b / SEG) * ((qb + TQ - 1) / TQ);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ctas);
  if (bf16)
    dist_segmin_kernel<true><<<grid, NT, 0, s>>>(q, d, qn, dn, ids, dist,
                                                 segmin, qb, b, na);
  else
    dist_segmin_kernel<false><<<grid, NT, 0, s>>>(q, d, qn, dn, ids, dist,
                                                  segmin, qb, b, na);
  return (int)cudaGetLastError();
}

}  // extern "C"
