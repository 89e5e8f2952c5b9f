// Cost-matrix rows against the vocabulary, sm_90a, plain CUDA C++: one
// pipelined tile loop, two epilogues, two tile shapes.
//
// Replaces three Pallas TPU kernels:
//   * `cdist_kexp_rows` (src/repro/kernels/kexp.py:93, body `_kexp_kernel`
//     :43), the K-cache misses: the exp epilogue on 128 x 128 tiles, so a
//     128-row miss chunk is one row of tiles and reads the vocabulary once;
//   * `cdist_kexp` (src/repro/kernels/kexp.py:58, the same body), one
//     query's (v_r, V) stripe: the exp epilogue on 32 x 128 tiles, so a
//     bucket of v_r <= 32 rows is one row of tiles and each block reads the
//     query's rows once (the TPU kernel keeps them resident and tiles V);
//   * `cdist` (src/repro/kernels/cdist.py:41, body `_cdist_kernel` :27),
//     the M-cache misses of the bound tiers: the distance epilogue on #6's
//     tile.
//
// What it computes, for rows a (m, w) against the vocabulary b (V, w):
//   M = sqrt(max(|a_i|^2 + |b_j|^2 - 2 <a_i, b_j>, 0))   (or M^2, squared)
//   exp epilogue:      K = exp(-lamb * M),  KM = K * M   (M never written)
//   distance epilogue: M (or max(d^2, 0))
// Outputs are (m, V) row-major.
//
// What bounds it on an H100: at m = 128 the 2*m*V*w fp32 operations (7.7
// GFLOP at V = 100,000, w = 300, against 67 TFLOP/s of non-tensor fp32),
// ahead of the bytes (b once, 120 MB, and 102 MB of K and K*M); at m = 32
// (one query) the bytes (b's 120 MB and 25.6 MB of K and K*M against 1.9
// GFLOP). It uses no tensor cores and no TF32: see "Exactness".
//
// Design: a SIMT fp32 product. A block of 256 threads owns a kRows x kCols
// output tile and walks w in kDepth-deep steps:
//   * cp.async ring: the step's kDepth-float slices of the tile's kRows
//     rows of a and kCols rows of b land in a ring of kStages slots as they
//     lie in memory, four neighbouring lanes copying a row's 64 contiguous
//     bytes, 16 bytes a copy (4 bytes when w % 4 != 0 or a base is
//     unaligned); the zero-fill of cp.async pads the tail of w (300 = 18 *
//     16 + 12), rows past m and columns past V. kStages - 1 steps are in
//     flight while the block computes.
//   * Each thread moves what it copied into a k-major buffer
//     (double-buffered, so one __syncthreads a step): no thread waits on
//     another's copies before the barrier. After it, thread t runs the
//     squared norm of tile row t over the step: the norms are spread over
//     all threads.
//   * A thread holds a kSubR x kSubC register tile (8 x 8 on #6 and #7,
//     4 x 4 on #5) in groups of 4 adjacent rows and columns, so each step
//     of k takes kSubR / 4 + kSubC / 4 128-bit shared loads for kSubR *
//     kSubC FMAs; a warp's lanes stand 4 rows by 8 columns, so a load is
//     one shared-memory wavefront.
//   * The epilogue writes groups of 4 adjacent outputs as one 128-bit
//     store where V % 4 == 0 (a warp writes 128 contiguous bytes on each of
//     4 rows), else as scalars.
// What was tried on an H100 and not kept: reading 4 k at a time straight
// from the [row][k] slots needs 32 + 32 operand registers on the 8 x 8
// tile, and nvcc spilled and filled the main loop with MOVs shuffling
// accumulators; a thread copying a whole row (16-byte pieces of 32 rows a
// warp instruction, twice the L2 sectors) was slower than four lanes a row.
//
// Exactness: every dot product and every norm is one thread's chain
// acc = __fmaf_rn(x_k, y_k, acc) from 0.f over k = 0..w-1 in order
// (zero-filled tail steps add exact zeros); there is no split-K and no
// atomics, and the epilogue (`cost_values`) is one function with its
// roundings spelled as intrinsics, so no instance contracts it differently.
// A row's bits therefore depend only on its own embedding and the
// vocabulary, never on the other rows of the call or on the tile shape: the
// row caches' bitwise on == off contracts rest on that, a query's stripe
// from `cdist_kexp` is bit for bit the K-cache rows `cdist_kexp_rows` makes
// for the same words, and the distance epilogue's M is bit for bit the M
// that the exp epilogue exponentiates (the bound tiers' soundness rests on
// that). A row's own word comes out as exactly M = 0, K = 1: |a|^2, |b|^2
// and <a, b> run the same chain over the same values, so the expansion
// cancels exactly, where a matmul spelling with separately summed norms
// leaves fp32 round-off (measured up to M = 2.5e-2 at w = 300 with cuBLAS).
// TF32, 3xTF32 or wgmma accumulation would not keep these chains.
// `cost_rows_naive` (one thread an output, no tiling, the same chains and
// epilogue) is the bitwise oracle of the tests; no path calls it.
// Compiled without --use_fast_math (expf and sqrt stay the accurate ones).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 16;            // w-slice a step stages

enum Epilogue { kExp = 0, kDist = 1, kDistSquared = 2 };

// One output's values from its two norms and its dot product; every
// instance and the oracle compute through it. |a|^2 + |b|^2 - 2ab is
// clamped at 0 by a max that, like the reference's maximum, keeps a NaN
// (2 * ab is exact, so the fused step equals the separate product and
// difference). out0: K, M or M^2; out1: K * M (exp epilogue only).
template <int kEpi>
__device__ __forceinline__ void cost_values(float a2, float b2, float ab,
                                            float lamb, float& out0,
                                            float& out1) {
  float d2 = __fmaf_rn(-2.f, ab, __fadd_rn(a2, b2));
  d2 = d2 < 0.f ? 0.f : d2;
  if (kEpi == kDistSquared) {
    out0 = d2;
    return;
  }
  const float dist = __fsqrt_rn(d2);
  if (kEpi == kDist) {
    out0 = dist;
    return;
  }
  const float kv = expf(__fmul_rn(-lamb, dist));
  out0 = kv;
  out1 = __fmul_rn(kv, dist);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Shared memory of an instance: the landing ring ([row][k], kStages slots),
// the k-major double buffer ([k][row], lines of kTileRows + 4 floats) and
// the norms.
template <int kRows, int kCols, int kStages>
struct Smem {
  static constexpr int kTileRows = kRows + kCols;
  static constexpr int kLine = kTileRows + 4;
  static constexpr int kSlot = kTileRows * kDepth;
  static constexpr int kBuf = kDepth * kLine;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)kStages * kSlot + 2 * kBuf + kTileRows);
};

template <int kEpi, int kRows, int kCols, int kSubR, int kSubC, int kStages,
          int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cost_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out0, float* __restrict__ out1, int m,
                 int v, int w, float lamb, int vec_in, int vec_out) {
  using S = Smem<kRows, kCols, kStages>;
  constexpr int kTileRows = S::kTileRows;
  constexpr int kGroupsR = kSubR / 4, kGroupsC = kSubC / 4;
  constexpr int kGapR = kRows / kGroupsR, kGapC = kCols / kGroupsC;
  constexpr int kTy = kRows / kSubR, kTx = kCols / kSubC;
  constexpr int kWarpsX = kTx / 8;
  static_assert(kSubR % 4 == 0 && kSubC % 4 == 0, "groups of 4");
  static_assert(kTy * kTx == kThreads && kTy % 4 == 0 && kTx % 8 == 0,
                "warps of 4 x 8 lanes must tile the block");
  static_assert(kTileRows % 32 == 0 && kTileRows <= kThreads,
                "a thread runs the norm of one tile row, in whole warps");
  extern __shared__ float4 smem4[];
  float* land = reinterpret_cast<float*>(smem4);
  float* kmaj = land + kStages * S::kSlot;
  float* norms = kmaj + 2 * S::kBuf;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // rows ty * 4 + g * kGapR + e and columns tx * 4 + h * kGapC + f
  const int ty = (warp / kWarpsX) * 4 + lane / 8;
  const int tx = (warp % kWarpsX) * 8 + lane % 8;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int nk = (w + kDepth - 1) / kDepth;

  // The 16-byte chunks this thread copies: chunk c = tid + i * kThreads is
  // chunk c % 4 of tile row c / 4 (a's rows first, then b's), so four
  // neighbouring lanes copy a row's 64 contiguous bytes.
  constexpr int kChunks = kTileRows * (kDepth / 4);
  constexpr int kMine = (kChunks + kThreads - 1) / kThreads;
  auto stage = [&](int kt, int slot) {
    const int k0 = kt * kDepth;
    float* dst = land + slot * S::kSlot;
    if (vec_in) {
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int c = tid + i * kThreads;
        if (kChunks % kThreads != 0 && c >= kChunks) continue;
        const int rr = c / 4, k = k0 + 4 * (c % 4);
        const bool is_a = rr < kRows;
        const int g = is_a ? row0 + rr : col0 + (rr - kRows);
        const float* base = is_a ? a : b;
        const bool ok = g < (is_a ? m : v) && k < w;
        cp_async16(dst + 4 * c, ok ? base + (size_t)g * w + k : base,
                   ok ? 16 : 0);
      }
    } else {   // element e of the slice of tile row r: c = r * kDepth + e
      for (int c = tid; c < kTileRows * kDepth; c += kThreads) {
        const int rr = c / kDepth, k = k0 + c % kDepth;
        const bool is_a = rr < kRows;
        const int g = is_a ? row0 + rr : col0 + (rr - kRows);
        const float* base = is_a ? a : b;
        const bool ok = g < (is_a ? m : v) && k < w;
        cp_async4(dst + c, ok ? base + (size_t)g * w + k : base, ok ? 4 : 0);
      }
    }
  };

  float acc[kSubR][kSubC];
#pragma unroll
  for (int i = 0; i < kSubR; ++i)
#pragma unroll
    for (int j = 0; j < kSubC; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;                  // |x|^2 of tile row tid

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of step kt
    // what it copied of step kt into the k-major buffer (whose readers,
    // step kt - 2, passed the last barrier)
    float* buf = kmaj + (kt & 1) * S::kBuf;
    const float* landed = land + (kt % kStages) * S::kSlot;
    if (vec_in) {
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int c = tid + i * kThreads;
        if (kChunks % kThreads != 0 && c >= kChunks) continue;
        const float4 x = *reinterpret_cast<const float4*>(landed + 4 * c);
        float* to = buf + 4 * (c % 4) * S::kLine + c / 4;
        to[0] = x.x;
        to[S::kLine] = x.y;
        to[2 * S::kLine] = x.z;
        to[3 * S::kLine] = x.w;
      }
    } else {
      for (int c = tid; c < kTileRows * kDepth; c += kThreads)
        buf[(c % kDepth) * S::kLine + c / kDepth] = landed[c];
    }
    // refill the slot this thread emptied at step kt - 1 (its own copies)
    const int next = kt + kStages - 1;
    if (next < nk) stage(next, next % kStages);
    cp_async_commit();
    __syncthreads();

    // the norm of tile row tid, one chain a row
    if (kTileRows == kThreads || tid < kTileRows) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const float x = buf[k * S::kLine + tid];
        nrm = __fmaf_rn(x, x, nrm);
      }
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float* line = buf + k * S::kLine;
      float ar[kSubR], br[kSubC];
#pragma unroll
      for (int g = 0; g < kGroupsR; ++g)
        *reinterpret_cast<float4*>(ar + 4 * g) =
            *reinterpret_cast<const float4*>(line + ty * 4 + g * kGapR);
#pragma unroll
      for (int h = 0; h < kGroupsC; ++h)
        *reinterpret_cast<float4*>(br + 4 * h) =
            *reinterpret_cast<const float4*>(line + kRows + tx * 4 +
                                             h * kGapC);
#pragma unroll
      for (int i = 0; i < kSubR; ++i)
#pragma unroll
        for (int j = 0; j < kSubC; ++j)
          acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();               // only empty groups are left
  if (kTileRows == kThreads || tid < kTileRows) norms[tid] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kSubR; ++i) {
    const int rt = ty * 4 + (i / 4) * kGapR + i % 4;
    const int row = row0 + rt;
    if (row >= m) continue;
    const float a2 = norms[rt];
#pragma unroll
    for (int h = 0; h < kGroupsC; ++h) {
      const int ct = tx * 4 + h * kGapC;
      const int col = col0 + ct;
      float o0[4], o1[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        cost_values<kEpi>(a2, norms[kRows + ct + f], acc[i][4 * h + f], lamb,
                          o0[f], o1[f]);
      const size_t at = (size_t)row * v + col;
      if (vec_out && col + 3 < v) {
        *reinterpret_cast<float4*>(out0 + at) =
            make_float4(o0[0], o0[1], o0[2], o0[3]);
        if (kEpi == kExp)
          *reinterpret_cast<float4*>(out1 + at) =
              make_float4(o1[0], o1[1], o1[2], o1[3]);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (col + f >= v) break;
          out0[at + f] = o0[f];
          if (kEpi == kExp) out1[at + f] = o1[f];
        }
      }
    }
  }
}

// Lets the instance take its dynamic shared memory (above the 48 KB a
// launch gets without asking) and the largest carveout.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// An instance: epilogue, tile, register tile, ring depth, blocks an SM.
template <int kEpi, int kRows, int kCols, int kSubR, int kSubC, int kStages,
          int kMinBlocks>
struct Tile {
  static constexpr size_t kBytes = Smem<kRows, kCols, kStages>::kBytes;

  // Blocks an SM holds and the dynamic shared memory a block takes.
  static int occupancy(int* blocks_per_sm, int* smem) {
    auto kernel = cost_rows_kernel<kEpi, kRows, kCols, kSubR, kSubC, kStages,
                                   kMinBlocks>;
    cudaError_t err = allow_smem(kernel, kBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, kThreads, kBytes);
    *smem = (int)kBytes;
    return (int)err;
  }

  static int launch(const void* a, const void* b, void* out0, void* out1,
                    int m, int v, int w, float lamb, void* stream) {
    if (m <= 0 || v <= 0 || w <= 0 || (m + kRows - 1) / kRows > 65535)
      return (int)cudaErrorInvalidValue;
    auto kernel = cost_rows_kernel<kEpi, kRows, kCols, kSubR, kSubC, kStages,
                                   kMinBlocks>;
    const cudaError_t err = allow_smem(kernel, kBytes);
    if (err != cudaSuccess) return (int)err;
    const int vec_in = w % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                       (uintptr_t)b % 16 == 0;
    const int vec_out = v % 4 == 0 && (uintptr_t)out0 % 16 == 0 &&
                        (uintptr_t)out1 % 16 == 0;
    const dim3 grid((v + kCols - 1) / kCols, (m + kRows - 1) / kRows);
    kernel<<<grid, kThreads, kBytes, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)out0, (float*)out1, m, v,
        w, lamb, vec_in, vec_out);
    return (int)cudaGetLastError();
  }
};

// #6: 128 x 128 tiles, 8 x 8 a thread, a ring of 3, two blocks an SM
// (<= 128 registers); #7 the same with the distance epilogue.
template <int kEpi>
using RowsTile = Tile<kEpi, 128, 128, 8, 8, 3, 2>;
// #5: 32 x 128 tiles, 4 x 4 a thread, a ring of 2, four blocks an SM
// (<= 64 registers). 32 x 256 tiles with 4 x 8 a thread and three blocks
// an SM were no faster on an H100 and spilled at their 80-register cap.
using QueryTile = Tile<kExp, 32, 128, 4, 4, 2, 4>;

// The oracle: one thread an output, no tiling, no shared memory.
template <int kEpi>
__global__ void cost_rows_naive_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ out0,
                                       float* __restrict__ out1, int m, int v,
                                       int w, float lamb) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= v || row >= m) return;
  const float* ar = a + (size_t)row * w;
  const float* br = b + (size_t)col * w;
  float a2 = 0.f, b2 = 0.f, ab = 0.f;
  for (int k = 0; k < w; ++k) {
    a2 = __fmaf_rn(ar[k], ar[k], a2);
    b2 = __fmaf_rn(br[k], br[k], b2);
    ab = __fmaf_rn(ar[k], br[k], ab);
  }
  const size_t at = (size_t)row * v + col;
  float o0, o1;
  cost_values<kEpi>(a2, b2, ab, lamb, o0, o1);
  out0[at] = o0;
  if (kEpi == kExp) out1[at] = o1;
}

template <int kEpi>
int launch_naive(const void* a, const void* b, void* out0, void* out1, int m,
                 int v, int w, float lamb, void* stream) {
  if (m <= 0 || v <= 0 || w <= 0 || m > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((v + kThreads - 1) / kThreads, m);
  cost_rows_naive_kernel<kEpi><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out0, (float*)out1, m, v, w,
      lamb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cdist_kexp_rows(const void* a, const void* b, void* k,
                               void* km, int m, int v, int w, float lamb,
                               void* stream) {
  return RowsTile<kExp>::launch(a, b, k, km, m, v, w, lamb, stream);
}

extern "C" int cdist_kexp(const void* a, const void* b, void* k, void* km,
                          int m, int v, int w, float lamb, void* stream) {
  return QueryTile::launch(a, b, k, km, m, v, w, lamb, stream);
}

extern "C" int cdist_rows(const void* a, const void* b, void* out, int m,
                          int v, int w, int squared, void* stream) {
  return squared ? RowsTile<kDistSquared>::launch(a, b, out, out, m, v, w,
                                                   0.f, stream)
                 : RowsTile<kDist>::launch(a, b, out, out, m, v, w, 0.f,
                                           stream);
}

// The tests' bitwise oracle for all three: epilogue 0 exp (out0 K, out1
// K*M), 1 distance, 2 squared distance (out0 only).
extern "C" int cost_rows_naive(const void* a, const void* b, void* out0,
                               void* out1, int m, int v, int w, int epilogue,
                               float lamb, void* stream) {
  switch (epilogue) {
    case kExp:
      return launch_naive<kExp>(a, b, out0, out1, m, v, w, lamb, stream);
    case kDist:
      return launch_naive<kDist>(a, b, out0, out1, m, v, w, lamb, stream);
    case kDistSquared:
      return launch_naive<kDistSquared>(a, b, out0, out1, m, v, w, lamb,
                                        stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The resident blocks an SM holds and the dynamic shared memory a block
// takes, for `which` 0 (#6 cdist_kexp_rows), 1 (#5 cdist_kexp) or 2 (#7
// cdist_rows): what chip_smoke.py reports beside ptxas's registers.
extern "C" int kexp_occupancy(int which, int* blocks_per_sm, int* smem) {
  switch (which) {
    case 0:
      return RowsTile<kExp>::occupancy(blocks_per_sm, smem);
    case 1:
      return QueryTile::occupancy(blocks_per_sm, smem);
    case 2:
      return RowsTile<kDist>::occupancy(blocks_per_sm, smem);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
