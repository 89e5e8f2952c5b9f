// Cost-matrix rows against the vocabulary, sm_90a, plain CUDA C++: one tile
// loop, two epilogues, two tile shapes.
//
// Replaces three Pallas TPU kernels:
//   * `cdist_kexp_rows` (src/repro/kernels/kexp.py:93, body `_kexp_kernel`
//     :43), the K-cache misses: the exp epilogue on 64 x 64 tiles;
//   * `cdist_kexp` (src/repro/kernels/kexp.py:58, the same body), one
//     query's (v_r, V) stripe: the exp epilogue on 32 x 128 tiles, so a
//     bucket of v_r <= 32 rows is one row of tiles and no tile row idles
//     (the TPU kernel keeps the query's rows resident and tiles only V);
//   * `cdist` (src/repro/kernels/cdist.py:41, body `_cdist_kernel` :27),
//     the M-cache misses of the bound tiers: the distance epilogue.
//
// What it computes, for rows a (m, w) against the vocabulary b (V, w):
//   M = sqrt(max(|a_i|^2 + |b_j|^2 - 2 <a_i, b_j>, 0))   (or M^2, squared)
//   exp epilogue:      K = exp(-lamb * M),  KM = K * M   (M never written)
//   distance epilogue: M (or max(d^2, 0))
// Outputs are (m, V) row-major.
//
// Design: a tiled SIMT fp32 product. A block of 256 threads owns a 64x64
// (or 32x128) output tile; it stages 16-deep slices of a and b in shared
// memory and each thread accumulates a 4x4 sub-tile in registers. The
// first 64 + 64 (or 32 + 128) threads also accumulate |a_i|^2 and |b_j|^2
// of the tile's rows and columns from the same shared tiles. Both epilogues
// and both tiles are instances of one kernel template, so they run the same
// tile loop and the same M expression (`clamped_d2`): the distance
// epilogue's M is bit for bit the M that the exp epilogue exponentiates. The bound tiers' soundness rests on that (the
// doc-side RWMD must see the geometry the engine's K*M encodes).
//
// What bounds it on an H100: the 2*m*V*w fp32 operations (at m = 128,
// V = 100,000, w = 300 that is 7.7 GFLOP against 67 TFLOP/s of non-tensor
// fp32), ahead of the bytes (b once, 120 MB, plus the outputs: K and K*M,
// 102 MB; or M alone, 51 MB). At m = 32 (one query) the bytes bound it:
// 1.9 GFLOP against b's 120 MB and 25.6 MB of K and K*M. This first
// version uses no tensor cores and no TF32: TF32 would move K far from the
// reference (the expansion cancels near the diagonal). A tensor-core redesign in 3xTF32 or a wgmma pipeline
// is later work.
//
// Exactness: every dot product and every norm is one thread's fma chain over
// k = 0..w-1 in order (zero-padded tail steps add exact zeros); there is no
// split-K and no atomics. A row's bits therefore depend only on its own
// embedding and the vocabulary, never on the other rows of the call or on
// the tile shape: the row caches' bitwise on == off contracts rest on that,
// and a query's stripe from `cdist_kexp` is bit for bit the K-cache rows
// `cdist_kexp_rows` makes for the same words. A row's own word comes out
// as exactly M = 0, K = 1: |a|^2, |b|^2 and <a, b> run the same
// fma chain over the same values, so the expansion cancels exactly, where
// a matmul spelling with separately summed norms leaves fp32 round-off
// (measured up to M = 2.5e-2 at w = 300 with cuBLAS). Compiled without
// --use_fast_math (expf and sqrtf stay the accurate versions).

#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 16;   // w-slice staged per step
constexpr int kThreads = 256;
constexpr int kSub = 4;      // 4x4 outputs per thread

enum Epilogue { kExp = 0, kDist = 1, kDistSquared = 2 };

// |a|^2 + |b|^2 - 2ab clamped at 0 by a max that, like the reference's
// maximum, keeps a NaN
__device__ __forceinline__ float clamped_d2(float a2, float b2, float ab) {
  const float d2 = a2 + b2 - 2.f * ab;
  return d2 < 0.f ? 0.f : d2;
}

// A block owns a kRows x kCols output tile (kRows * kCols = 16 * kThreads):
// thread (ty, tx) holds rows ty + kTy * ii and columns tx + kTx * jj.
template <int kEpi, int kRows, int kCols>
__global__ void __launch_bounds__(kThreads)
cost_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out0, float* __restrict__ out1,
                 int m, int v, int w, float lamb) {
  constexpr int kTx = kCols / kSub;   // threads along the columns
  constexpr int kTy = kRows / kSub;
  constexpr int kMaxTile = kRows > kCols ? kRows : kCols;
  static_assert(kTx * kTy == kThreads, "tile does not match the block");
  static_assert(kRows + kCols <= kThreads, "too few threads for the norms");
  __shared__ float as[kDepth][kRows + 1];
  __shared__ float bs[kDepth][kCols + 1];
  __shared__ float a2s[kRows];
  __shared__ float b2s[kCols];

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;

  float acc[kSub][kSub];
#pragma unroll
  for (int ii = 0; ii < kSub; ++ii)
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) acc[ii][jj] = 0.f;
  float norm = 0.f;            // |a|^2 (tid < kRows) or |b|^2 (< kRows+kCols)

  for (int k0 = 0; k0 < w; k0 += kDepth) {
    for (int e = tid; e < kMaxTile * kDepth; e += kThreads) {
      const int rr = e / kDepth, kk = e % kDepth;
      const int gk = k0 + kk;
      const int ga = row0 + rr, gb = col0 + rr;
      if (rr < kRows)
        as[kk][rr] = (ga < m && gk < w) ? a[(size_t)ga * w + gk] : 0.f;
      if (rr < kCols)
        bs[kk][rr] = (gb < v && gk < w) ? b[(size_t)gb * w + gk] : 0.f;
    }
    __syncthreads();
    if (tid < kRows + kCols) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float x = tid < kRows ? as[kk][tid] : bs[kk][tid - kRows];
        norm += x * x;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float ar[kSub], br[kSub];
#pragma unroll
      for (int ii = 0; ii < kSub; ++ii) ar[ii] = as[kk][ty + kTy * ii];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) br[jj] = bs[kk][tx + kTx * jj];
#pragma unroll
      for (int ii = 0; ii < kSub; ++ii)
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) acc[ii][jj] += ar[ii] * br[jj];
    }
    __syncthreads();
  }
  if (tid < kRows) a2s[tid] = norm;
  else if (tid < kRows + kCols) b2s[tid - kRows] = norm;
  __syncthreads();

#pragma unroll
  for (int ii = 0; ii < kSub; ++ii) {
    const int row = row0 + ty + kTy * ii;
    if (row >= m) continue;
    const float a2 = a2s[ty + kTy * ii];
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) {
      const int col = col0 + tx + kTx * jj;
      if (col >= v) continue;
      const float d2 = clamped_d2(a2, b2s[tx + kTx * jj], acc[ii][jj]);
      const size_t at = (size_t)row * v + col;
      if (kEpi == kDistSquared) {
        out0[at] = d2;
      } else {
        const float dist = sqrtf(d2);
        if (kEpi == kDist) {
          out0[at] = dist;
        } else {
          const float kv = expf(-lamb * dist);
          out0[at] = kv;
          out1[at] = kv * dist;
        }
      }
    }
  }
}

template <int kEpi, int kRows, int kCols>
int launch(const void* a, const void* b, void* out0, void* out1, int m,
           int v, int w, float lamb, void* stream) {
  if (m <= 0 || v <= 0 || w <= 0 || (m + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((v + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  cost_rows_kernel<kEpi, kRows, kCols>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)a, (const float*)b, (float*)out0, (float*)out1, m, v,
          w, lamb);
  return (int)cudaGetLastError();
}

}  // namespace

// Row tiles: 64 x 64 for the cache's miss chunks (up to 128 rows) and the
// M rows; 32 x 128 for one query's stripe (v_r <= 32 a tile, so no tile
// row is computed for nothing).
extern "C" int cdist_kexp_rows(const void* a, const void* b, void* k,
                               void* km, int m, int v, int w, float lamb,
                               void* stream) {
  return launch<kExp, 64, 64>(a, b, k, km, m, v, w, lamb, stream);
}

extern "C" int cdist_kexp(const void* a, const void* b, void* k, void* km,
                          int m, int v, int w, float lamb, void* stream) {
  return launch<kExp, 32, 128>(a, b, k, km, m, v, w, lamb, stream);
}

extern "C" int cdist_rows(const void* a, const void* b, void* out, int m,
                          int v, int w, int squared, void* stream) {
  return squared
             ? launch<kDistSquared, 64, 64>(a, b, out, nullptr, m, v, w, 0.f,
                                            stream)
             : launch<kDist, 64, 64>(a, b, out, nullptr, m, v, w, 0.f,
                                     stream);
}
