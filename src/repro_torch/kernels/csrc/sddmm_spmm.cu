// Fused SDDMM-SpMM for the Sinkhorn-WMD iteration (type1) and the final
// distance (type2), single-query and batched, sm_90a, plain CUDA C++.
//
// Replaces four Pallas TPU kernels:
//   * `sddmm_spmm_type1_batch` / `sddmm_spmm_type2_batch`
//     (src/repro/kernels/sddmm_spmm.py:239 and :272, bodies
//     `_type1_batch_kernel` :182 and `_type2_batch_kernel` :209), Q queries;
//   * `sddmm_spmm_type1` / `sddmm_spmm_type2` (:126 and :154, bodies
//     `_type1_kernel` :71 and `_type2_kernel` :97), one query.
//
// What it computes, for query q and document j, over the ELL slots s of j:
//   w   = <K[q, :, cols[j,s]], u[q, :, j]>             (SDDMM dot)
//   v   = vals[j,s] / max(w, 1e-30)   (0 where vals == 0)
//   acc += K[q, :, cols[j,s]] * v      type1          (SpMM, same column)
//   acc += KM[q, :, cols[j,s]] * v     type2
// type1 writes x[q, :, j] = acc / r[q, :]; type2 writes wmd[q, j] = <u, acc>.
//
// Design: one warp per (q, j); lane l holds query-word rows l, l+32, ...
// (R rows, R = ceil(v_r / 32) <= 4). The K column of a slot is loaded once
// into registers and feeds both the dot (a warp butterfly reduction) and
// the accumulation, as the TPU kernel's single VMEM gather does. A block of
// min(docs_blk, 8) warps walks the docs_blk documents of its tile. That
// step (`doc_tile`) is one device function; two grids call it: the batched
// grid (ceil(N / docs_blk), Q) and the single-query grid ceil(N / docs_blk).
// A single-query launch is therefore the batched launch at Q = 1, bit for
// bit.
//
// What bounds it on an H100: memory traffic. Per slot it reads v_r floats
// of K (and of K*M for type2) at stride V+1 (the reference layout
// (Q, v_r, V+1)), so each lane touches its own 32-byte sector: the loads
// move 8x the useful bytes. The arithmetic is 4 flops per row per slot,
// far below the fp32 rate. A vocab-major copy of K would make a column one
// 128-byte line; that is a later optimisation, not done here. At Q = 1
// (one query's 12.8 MB stripe, resident in the 50 MB L2) the work is too
// small to fill the card for long: launch and latency bound it.
//
// Exactness: every output element is one warp's fixed-order sum, with no
// atomics and no dependence on docs_blk or on other documents, so the
// port's bitwise contracts (chunked == unchunked, cache on == off) hold.
// Pad slots (vals == 0) are skipped: they add exactly +0. Pad query rows
// (all-zero K, r = 1) and Q-filler queries (all-zero K, so w = 0 and
// v = val / 1e-30 times a zero column) come out as exact zeros. Compiled
// without --use_fast_math: IEEE division is part of that contract.

#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: every lane ends with the same bits (fp add commutes)
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One query's documents j0 .. j_end-1, one warp per document: the shared
// per-(query, doc) step of the single-query and the batched grids. Pointers
// are the query's own: k / km (v_r, vp1), r (v_r), u and x (v_r, n), wmd (n).
template <int R, bool kType2>
__device__ __forceinline__ void doc_tile(
    const float* __restrict__ kq, const float* __restrict__ kmq,
    const float* __restrict__ rq, const float* __restrict__ uq,
    const int* __restrict__ cols, const float* __restrict__ vals,
    float* __restrict__ outq, int v_r, int vp1, int n, int nnz, int j0,
    int j_end) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  for (int j = j0 + warp; j < j_end; j += warps) {
    float uj[R], acc[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + t * kWarp;
      uj[t] = i < v_r ? uq[(size_t)i * n + j] : 0.f;
      acc[t] = 0.f;
    }
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    for (int s = 0; s < nnz; ++s) {
      const float val = vj[s];
      if (val == 0.f) continue;              // pad slot: adds exactly +0
      const size_t c = (size_t)cj[s];
      float kc[R];
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        kc[t] = i < v_r ? kq[(size_t)i * vp1 + c] : 0.f;
        part += kc[t] * uj[t];
      }
      const float w = warp_sum(part);
      // max(w, TINY) that, like the reference's maximum, keeps a NaN
      const float v = val / (w < kTiny ? kTiny : w);
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        float col = kc[t];
        if (kType2) col = i < v_r ? kmq[(size_t)i * vp1 + c] : 0.f;
        acc[t] += col * v;
      }
    }
    if (kType2) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < R; ++t) part += uj[t] * acc[t];
      const float d = warp_sum(part);
      if (lane == 0) outq[j] = d;
    } else {
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        if (i < v_r) outq[(size_t)i * n + j] = acc[t] / rq[i];
      }
    }
  }
}

// The batched grid, (ceil(N / docs_blk), Q): block (tile, q) walks query
// q's documents of its tile.
template <int R, bool kType2>
__global__ void sddmm_spmm_batch_kernel(
    const float* __restrict__ k,     // (Q, v_r, vp1)
    const float* __restrict__ km,    // (Q, v_r, vp1), type2 only
    const float* __restrict__ r,     // (Q, v_r), type1 only
    const float* __restrict__ u,     // (Q, v_r, N)
    const int* __restrict__ cols,    // (N, nnz)
    const float* __restrict__ vals,  // (N, nnz)
    float* __restrict__ out,         // type1 x (Q, v_r, N); type2 wmd (Q, N)
    int v_r, int vp1, int n, int nnz, int docs_blk) {
  const size_t q = blockIdx.y;
  const size_t stripe = (size_t)v_r * vp1;
  const int j0 = blockIdx.x * docs_blk;
  doc_tile<R, kType2>(k + q * stripe, kType2 ? km + q * stripe : nullptr,
                      kType2 ? nullptr : r + q * v_r, u + q * v_r * n, cols,
                      vals, out + (kType2 ? q * n : q * v_r * n), v_r, vp1,
                      n, nnz, j0, min(j0 + docs_blk, n));
}

// The single-query grid, ceil(N / docs_blk) blocks: one query's (v_r, vp1)
// stripes, r (v_r), u (v_r, N) -> x (v_r, N) or wmd (N). The same step as
// the batched grid, so its output is the batched grid's at Q = 1, bit for
// bit.
template <int R, bool kType2>
__global__ void sddmm_spmm_query_kernel(
    const float* __restrict__ k, const float* __restrict__ km,
    const float* __restrict__ r, const float* __restrict__ u,
    const int* __restrict__ cols, const float* __restrict__ vals,
    float* __restrict__ out, int v_r, int vp1, int n, int nnz,
    int docs_blk) {
  const int j0 = blockIdx.x * docs_blk;
  doc_tile<R, kType2>(k, km, r, u, cols, vals, out, v_r, vp1, n, nnz, j0,
                      min(j0 + docs_blk, n));
}

template <int R, bool kType2>
void launch_grid(bool batched, dim3 grid, dim3 block, cudaStream_t stream,
                 const float* k, const float* km, const float* r,
                 const float* u, const int* cols, const float* vals,
                 float* out, int v_r, int vp1, int n, int nnz, int docs_blk) {
  if (batched)
    sddmm_spmm_batch_kernel<R, kType2><<<grid, block, 0, stream>>>(
        k, km, r, u, cols, vals, out, v_r, vp1, n, nnz, docs_blk);
  else
    sddmm_spmm_query_kernel<R, kType2><<<grid, block, 0, stream>>>(
        k, km, r, u, cols, vals, out, v_r, vp1, n, nnz, docs_blk);
}

// batched: the (tiles, q) grid; else the single-query grid (q == 1).
template <bool kType2>
int launch(const float* k, const float* km, const float* r, const float* u,
           const int* cols, const float* vals, float* out, int q,
           bool batched, int v_r, int vp1, int n, int nnz, int docs_blk,
           cudaStream_t stream) {
  if (q <= 0 || q > 65535 || (!batched && q != 1) || n <= 0 || v_r <= 0 ||
      v_r > 4 * kWarp || docs_blk <= 0)
    return (int)cudaErrorInvalidValue;
  const int warps = docs_blk < kMaxWarpsPerBlock ? docs_blk : kMaxWarpsPerBlock;
  const dim3 grid((n + docs_blk - 1) / docs_blk, q);
  const dim3 block(warps * kWarp);
  const int rows = (v_r + kWarp - 1) / kWarp;
  if (rows == 1)
    launch_grid<1, kType2>(batched, grid, block, stream, k, km, r, u, cols,
                           vals, out, v_r, vp1, n, nnz, docs_blk);
  else if (rows == 2)
    launch_grid<2, kType2>(batched, grid, block, stream, k, km, r, u, cols,
                           vals, out, v_r, vp1, n, nnz, docs_blk);
  else
    launch_grid<4, kType2>(batched, grid, block, stream, k, km, r, u, cols,
                           vals, out, v_r, vp1, n, nnz, docs_blk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sddmm_spmm_type1_batch(const void* k, const void* r,
                                      const void* u, const void* cols,
                                      const void* vals, void* x, int q,
                                      int v_r, int vp1, int n, int nnz,
                                      int docs_blk, void* stream) {
  return launch<false>((const float*)k, nullptr, (const float*)r,
                       (const float*)u, (const int*)cols, (const float*)vals,
                       (float*)x, q, true, v_r, vp1, n, nnz, docs_blk,
                       (cudaStream_t)stream);
}

extern "C" int sddmm_spmm_type2_batch(const void* k, const void* km,
                                      const void* u, const void* cols,
                                      const void* vals, void* wmd, int q,
                                      int v_r, int vp1, int n, int nnz,
                                      int docs_blk, void* stream) {
  return launch<true>((const float*)k, (const float*)km, nullptr,
                      (const float*)u, (const int*)cols, (const float*)vals,
                      (float*)wmd, q, true, v_r, vp1, n, nnz, docs_blk,
                      (cudaStream_t)stream);
}

extern "C" int sddmm_spmm_type1(const void* k, const void* r, const void* u,
                                const void* cols, const void* vals, void* x,
                                int v_r, int vp1, int n, int nnz,
                                int docs_blk, void* stream) {
  return launch<false>((const float*)k, nullptr, (const float*)r,
                       (const float*)u, (const int*)cols, (const float*)vals,
                       (float*)x, 1, false, v_r, vp1, n, nnz, docs_blk,
                       (cudaStream_t)stream);
}

extern "C" int sddmm_spmm_type2(const void* k, const void* km, const void* u,
                                const void* cols, const void* vals, void* wmd,
                                int v_r, int vp1, int n, int nnz,
                                int docs_blk, void* stream) {
  return launch<true>((const float*)k, (const float*)km, nullptr,
                      (const float*)u, (const int*)cols, (const float*)vals,
                      (float*)wmd, 1, false, v_r, vp1, n, nnz, docs_blk,
                      (cudaStream_t)stream);
}
