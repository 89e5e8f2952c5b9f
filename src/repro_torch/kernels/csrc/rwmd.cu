// Doc-side RWMD lower bounds of the retrieval cascade, sm_90a, plain CUDA
// C++: the batched min-SDDMM (tier 2 and the bounds tier) and the LC-RWMD
// sparse dot (tier 1).
//
// Replaces the Pallas TPU kernels `rwmd_bound_batch`
// (src/repro/kernels/rwmd.py:62, body `_rwmd_kernel` :38) and
// `lc_rwmd_bound_batch` (src/repro/kernels/lcrwmd.py:60, body `_lc_kernel`
// :37).
//
// What they compute, for query q and document j, over the ELL slots s of j
// with vals[j, s] != 0:
//   rwmd: lb[q, j] = sum_s vals[j, s] * min_i M[q, i, cols[j, s]]
//   lc:   lb[q, j] = sum_s vals[j, s] * minm[q, cols[j, s]]
// with minm[q, c] = min_i M[q, i, c] taken outside (`torch.amin`, exact).
// Pad query rows carry +inf in M and never win the min; an all-pad filler
// query gives +inf, which the `ops` wrappers finite-ize to 0.
//
// Design. rwmd: one warp per (q, j), as the SDDMM-SpMM kernels: lane l
// holds query-word rows l, l+32, ... (R = ceil(v_r / 32) <= 4), the warp
// takes the min over the M column with an xor butterfly (min is exact and
// order-free, so every lane ends with the same bits). lc: one thread per
// (q, j). A block of min(docs_blk, 8) warps (rwmd) or min(docs_blk, 256)
// threads (lc) walks the docs_blk documents of its tile; the grid is
// (ceil(N / docs_blk), Q).
//
// Exactness: both kernels accumulate in slot order s = 0..nnz-1 through the
// ONE step `bound_step` (an explicitly rounded fma), so no contraction can
// differ between them, and the two mins are the same float: the LC bound
// equals the doc-side bound to the bit, the tier-subsumption property of
// the reference (tests/test_cascade_properties.py:124). Pad slots
// (val == 0) are skipped by a branch, never multiplied: a filler query's
// pad slot has min = +inf, and 0 * inf = NaN. No atomics, no split over
// slots; results do not depend on docs_blk.
//
// What bounds them on an H100: memory traffic. rwmd reads v_r floats of M
// per nonzero slot at stride V+1 (the reference layout (Q, v_r, V+1)), one
// 32-byte sector per lane, 8x the useful bytes; the arithmetic is about v_r
// operations per slot, far below the fp32 rate. lc reads one float of minm
// per slot (a (V+1) row per query, 400 KB at V = 100,000, which stays in
// L2) plus the ELL; its threads read their own ELL rows at stride nnz, so a
// warp's loads are not coalesced. Both are simple first versions: a
// vocab-major M and a warp-per-doc ELL walk are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxThreadsPerBlock = 256;

// The one accumulation step of both bounds.
__device__ __forceinline__ float bound_step(float acc, float val, float mn) {
  return __fmaf_rn(val, mn, acc);
}

// min that, like jnp.min and torch.amin, keeps a NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = nan_min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int R>
__global__ void rwmd_bound_kernel(const float* __restrict__ m,     // (Q, v_r, vp1)
                                  const int* __restrict__ cols,    // (N, nnz)
                                  const float* __restrict__ vals,  // (N, nnz)
                                  float* __restrict__ lb,          // (Q, N)
                                  int v_r, int vp1, int n, int nnz,
                                  int docs_blk) {
  const int q = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int j0 = blockIdx.x * docs_blk;
  const int j_end = min(j0 + docs_blk, n);
  const float* mq = m + (size_t)q * v_r * vp1;

  for (int j = j0 + warp; j < j_end; j += warps) {
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    float acc = 0.f;
    for (int s = 0; s < nnz; ++s) {
      const float val = vj[s];
      if (val == 0.f) continue;              // pad slot: never 0 * inf
      const size_t c = (size_t)cj[s];
      float mn = INFINITY;                   // lanes past v_r: pad rows
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        if (i < v_r) mn = nan_min(mn, mq[(size_t)i * vp1 + c]);
      }
      acc = bound_step(acc, val, warp_min(mn));
    }
    if (lane == 0) lb[(size_t)q * n + j] = acc;
  }
}

__global__ void lc_rwmd_bound_kernel(const float* __restrict__ minm,  // (Q, vp1)
                                     const int* __restrict__ cols,
                                     const float* __restrict__ vals,
                                     float* __restrict__ lb,
                                     int vp1, int n, int nnz, int docs_blk) {
  const int q = blockIdx.y;
  const int j0 = blockIdx.x * docs_blk;
  const int j_end = min(j0 + docs_blk, n);
  const float* mq = minm + (size_t)q * vp1;

  for (int j = j0 + threadIdx.x; j < j_end; j += blockDim.x) {
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    float acc = 0.f;
    for (int s = 0; s < nnz; ++s) {
      const float val = vj[s];
      if (val == 0.f) continue;              // pad slot: never 0 * inf
      acc = bound_step(acc, val, mq[cj[s]]);
    }
    lb[(size_t)q * n + j] = acc;
  }
}

bool bad_grid(int q, int n, int docs_blk) {
  return q <= 0 || n <= 0 || docs_blk <= 0 || q > 65535;
}

}  // namespace

extern "C" int rwmd_bound_batch(const void* m, const void* cols,
                                const void* vals, void* lb, int q, int v_r,
                                int vp1, int n, int nnz, int docs_blk,
                                void* stream) {
  if (bad_grid(q, n, docs_blk) || v_r <= 0 || v_r > 4 * kWarp)
    return (int)cudaErrorInvalidValue;
  const int warps = docs_blk < kMaxWarpsPerBlock ? docs_blk : kMaxWarpsPerBlock;
  const dim3 grid((n + docs_blk - 1) / docs_blk, q);
  const dim3 block(warps * kWarp);
  const int rows = (v_r + kWarp - 1) / kWarp;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* mp = (const float*)m;
  const int* cp = (const int*)cols;
  const float* vp = (const float*)vals;
  float* out = (float*)lb;
  if (rows == 1)
    rwmd_bound_kernel<1><<<grid, block, 0, st>>>(mp, cp, vp, out, v_r, vp1,
                                                n, nnz, docs_blk);
  else if (rows == 2)
    rwmd_bound_kernel<2><<<grid, block, 0, st>>>(mp, cp, vp, out, v_r, vp1,
                                                n, nnz, docs_blk);
  else
    rwmd_bound_kernel<4><<<grid, block, 0, st>>>(mp, cp, vp, out, v_r, vp1,
                                                n, nnz, docs_blk);
  return (int)cudaGetLastError();
}

extern "C" int lc_rwmd_bound_batch(const void* minm, const void* cols,
                                   const void* vals, void* lb, int q,
                                   int vp1, int n, int nnz, int docs_blk,
                                   void* stream) {
  if (bad_grid(q, n, docs_blk)) return (int)cudaErrorInvalidValue;
  const int threads =
      docs_blk < kMaxThreadsPerBlock ? docs_blk : kMaxThreadsPerBlock;
  const dim3 grid((n + docs_blk - 1) / docs_blk, q);
  lc_rwmd_bound_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)minm, (const int*)cols, (const float*)vals, (float*)lb,
      vp1, n, nnz, docs_blk);
  return (int)cudaGetLastError();
}
