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
// the f32 rows. The operands arrive attribute-major (qT (A, ldq), dT (A, B))
// and already rounded where the product is bf16 (ops/dist_segmin.py
// prepare_operands), so one body serves both precisions and accumulates in
// f32.
//
// What bounds it on the card. At the router's outlier shape (5,624 x 50,176
// x 64) the product is 2 * 5624 * 50176 * 64 = 36.1 GFLOP, 0.54 ms at the
// 67 TFLOP/s FP32 peak; the distance tile it writes is 1.13 GB, 0.34 ms at
// 3.35 TB/s. Operations bound it, then the store. The product runs on the
// CUDA cores in IEEE f32: the eps bounds of engine/finalize.py are derived
// for full f32 products, so no tensor-core or reduced-precision path.
//
// Design, against those two bounds:
//   1. A CTA tile of TQ = 128 query rows by one SEG = 128-column segment.
//      256 threads, each with an 8 x 8 register micro-tile: rows
//      {4ty..4ty+3, 64+4ty..64+4ty+3}, columns {4tx..4tx+3, 64+4tx..}, read
//      as float4s from shared memory: 4 shared loads per 64 FMAs. A warp
//      holds 2 thread-rows x 16 thread-columns, so a row's segment minimum
//      is 16 lanes of one warp, reduced by shuffles with no shared pass.
//   2. A CTA walks G consecutive segments of one row tile (G from
//      ops/dist_segmin.py choose_group, so the grid fills whole waves of
//      CTAS_PER_SM CTAs per SM). Chunks of AK attributes of both operands
//      ([AK][128] contiguous per side) stream through a STAGES-deep ring in
//      dynamic shared memory by 16-byte cp.async, over the flattened
//      (segment, chunk) sequence: the next segment's first chunks are in
//      flight during the current segment's epilogue. Attributes past na are
//      zero-filled by the copy; a zero product leaves the f32 sum unchanged.
//   3. The epilogue loads the segment's dn and ids once as vectors, stores
//      each row's 8 values as two 16-byte streaming stores (the tile is 22x
//      the L2 and is read back only by a later gather) and its minimum once.
//   4. Each output is the sequential fmaf chain over a = 0..na-1, then
//      (qn + dn) - 2 acc with (qn + dn) summed first, as the reference sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;          // segment width = data columns per tile
constexpr int TQ = 128;           // query rows per tile
constexpr int NT = 256;           // threads per CTA
constexpr int TX = 16;            // thread columns: lanes that share a row
constexpr int MT = 8;             // micro-tile: MT rows x MT columns a thread
constexpr int AK = 16;            // attributes per pipeline stage
constexpr int STAGES = 4;         // depth of the shared-memory ring
constexpr int CTAS_PER_SM = 2;    // resident CTAs per SM (launch bounds)
constexpr int STAGE_FLOATS = AK * TQ + AK * SEG;   // [AK][TQ] q, [AK][SEG] d
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);
constexpr int COPIES = AK * TQ / 4 / NT;           // 16-byte copies a side

static_assert(TQ == SEG && NT == (TQ / MT) * (SEG / MT) && TX == SEG / MT,
              "the thread grid covers the tile with 8 x 8 micro-tiles");
static_assert(COPIES * NT * 4 == AK * TQ, "whole 16-byte copies per stage");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(NT, CTAS_PER_SM)
dist_segmin_kernel(const float* __restrict__ qT, const float* __restrict__ dT,
                   const float* __restrict__ qn, const float* __restrict__ dn,
                   const int* __restrict__ ids, float* __restrict__ dist,
                   float* __restrict__ segmin, int qb, int ldq, int b, int na,
                   int group) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int nseg = b / SEG;
  const int ngroups = (nseg + group - 1) / group;
  const int row0 = (int)(blockIdx.x / ngroups) * TQ;
  const int seg0 = (int)(blockIdx.x % ngroups) * group;
  const int nch = (na + AK - 1) / AK;
  const int steps = min(group, nseg - seg0) * nch;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  // Stage t of the flattened (segment, chunk) sequence into ring slot
  // t % STAGES; one commit group per call, empty past the last step. Warp
  // w copies attribute rows w, w + 8, ...; lane l columns 4l..4l+3.
  const int cp_row = tid / (TQ / 4), cp_col = (tid % (TQ / 4)) * 4;
  const float* const q_src = qT + row0 + cp_col;
  const float* const d_src = dT + cp_col;
  auto load = [&](int t) {
    if (t < steps) {
      float* qs = smem + (t % STAGES) * STAGE_FLOATS + cp_row * TQ + cp_col;
      float* ds = qs + AK * TQ;
      const size_t col0 = (size_t)(seg0 + t / nch) * SEG;
      const int a0 = (t % nch) * AK + cp_row;
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        const int a = a0 + k * (NT / (TQ / 4));
        const bool ok = a < na;
        const size_t ar = ok ? (size_t)a : 0;
        cp_async16(qs + k * (NT / (TQ / 4)) * TQ, q_src + ar * ldq, ok);
        cp_async16(ds + k * (NT / (TQ / 4)) * SEG, d_src + ar * b + col0, ok);
      }
    }
    cp_async_commit();
  };

  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load(t);

  int chunk = 0, seg = seg0;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed (this thread's part)
    __syncthreads();              // ... everyone's; slot t-1 is free again
    load(t + STAGES - 1);
    const float* qs = smem + (t % STAGES) * STAGE_FLOATS;
    const float* ds = qs + AK * TQ;
#pragma unroll
    for (int k = 0; k < AK; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(qs + k * TQ + 4 * ty);
      const float4 x1 =
          *reinterpret_cast<const float4*>(qs + k * TQ + TQ / 2 + 4 * ty);
      const float4 y0 = *reinterpret_cast<const float4*>(ds + k * SEG + 4 * tx);
      const float4 y1 =
          *reinterpret_cast<const float4*>(ds + k * SEG + SEG / 2 + 4 * tx);
      const float xr[MT] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float yc[MT] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(xr[i], yc[j], acc[i][j]);
    }
    if (++chunk < nch) continue;

    // Epilogue of segment `seg`: registers and global memory only, while
    // the ring already holds the next segment's chunks.
    const int c0 = seg * SEG;
    const float4 n0 = *reinterpret_cast<const float4*>(dn + c0 + 4 * tx);
    const float4 n1 =
        *reinterpret_cast<const float4*>(dn + c0 + SEG / 2 + 4 * tx);
    const int4 i0 = *reinterpret_cast<const int4*>(ids + c0 + 4 * tx);
    const int4 i1 = *reinterpret_cast<const int4*>(ids + c0 + SEG / 2 + 4 * tx);
    const float dnv[MT] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    // Bit j: column j of this thread is a sentinel (one register, not 8).
    const unsigned smask = (i0.x < 0) | (i0.y < 0) << 1 | (i0.z < 0) << 2 |
                           (i0.w < 0) << 3 | (i1.x < 0) << 4 |
                           (i1.y < 0) << 5 | (i1.z < 0) << 6 |
                           (i1.w < 0) << 7;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = row0 + (i < 4 ? 4 * ty + i : TQ / 2 + 4 * ty + i - 4);
      const bool live = row < qb;
      const float qnv = live ? qn[row] : 0.f;
      float* out = dist + (size_t)row * b + c0 + 4 * tx;
      float m = INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * h + jj;
          // (qn + dn) first, as the reference sums; 2 * acc is exact, so a
          // contracted FMA gives the same rounding.
          const float s = qnv + dnv[j];
          v[jj] = (smask >> j & 1u) ? INFINITY
                                    : fmaxf(s - 2.f * acc[i][j], 0.f);
          m = fminf(m, v[jj]);
          acc[i][j] = 0.f;
        }
        if (live)
          __stcs(reinterpret_cast<float4*>(out + h * (SEG / 2)),
                 make_float4(v[0], v[1], v[2], v[3]));
      }
      // The row's 16 lanes are one half-warp; every lane takes part, live
      // or not, so the shuffles stay full-warp.
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (live && tx == 0) segmin[(size_t)row * nseg + seg] = m;
    }
    chunk = 0;
    ++seg;
  }
}

}  // namespace

extern "C" {

// Tile constants, so the Python side can check the kernel it loaded.
int dmlp_segmin_seg() { return SEG; }
int dmlp_segmin_tile_q() { return TQ; }
int dmlp_segmin_ctas_per_sm() { return CTAS_PER_SM; }

// Resident CTAs per SM that the current device achieves for this kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -cudaError_t.
int dmlp_segmin_occupancy() {
  cudaError_t e = cudaFuncSetAttribute(
      dist_segmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dist_segmin_kernel,
                                                      NT, SMEM_BYTES);
  return e == cudaSuccess ? n : -(int)e;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// qT (na, ldq) and dT (na, b) f32 attribute-major, ldq a multiple of TQ
// (rows qb..ldq-1 are padding); qn (qb,), dn (b,) f32; ids (b,) i32; dn and
// ids 16-byte aligned. dist (qb, b) and segmin (qb, b / SEG) f32 are
// written. b % SEG == 0; a CTA walks `group` consecutive segments.
int dmlp_dist_segmin(const float* qT, const float* dT, const float* qn,
                     const float* dn, const int* ids, float* dist,
                     float* segmin, int qb, int ldq, int b, int na, int group,
                     void* stream) {
  if (qb <= 0 || b <= 0 || b % SEG != 0 || na <= 0 || ldq % TQ != 0 ||
      ldq < qb || group < 1 || group > b / SEG)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)((b / SEG + group - 1) / group) *
                         ((qb + TQ - 1) / TQ);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dist_segmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dist_segmin_kernel<<<(unsigned)ctas, NT, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      qT, dT, qn, dn, ids, dist, segmin, qb, ldq, b, na, group);
  return (int)cudaGetLastError();
}

}  // extern "C"
