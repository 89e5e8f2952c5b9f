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
// order-free, so every lane ends with the same bits). A block of
// min(docs_blk, 8) warps walks the docs_blk documents of its tile; the grid
// is (ceil(N / docs_blk), Q).
//
// lc: one warp per document serves ALL queries, in groups of qg = min(next
// power of two >= Q, 32) queries (grid.y counts the groups); a block of 4
// warps walks a tile of docs_blk documents (rounded up to a multiple of 4).
// minm is read vocab-major, (V+1, Q): the queries of one word are
// adjacent, so one slot's minm for 16 queries is one 64-byte line.
// `core.cascade.min_cost_vectors` writes minm so (its reduction's output
// is the vocab-major tensor); a caller with a row-major minm gets a copy
// in the wrapper. A stage covers 32 slots of the document, one a lane: lane s
// loads its slot's col / val (coalesced), and, if the slot is live, its
// minm line (16-byte loads where the alignment allows) into the warp's
// shared-memory table, with rows padded so that the lanes' rows fall in
// distinct banks; the next stage's col / val loads are in flight
// meanwhile. Then lane q walks the stage's slots in order, up to the last
// live one (a ballot skips empty stages), reading its minm from the table.
// A document's loads are thus 32 at a time in flight, while its
// accumulation stays one thread's fixed-order chain.
//
// Exactness: both kernels accumulate in slot order s = 0..nnz-1 through the
// ONE step `bound_step` (an explicitly rounded fma), so no contraction can
// differ between them, and the two mins are the same float: the LC bound
// equals the doc-side bound to the bit, the tier-subsumption property of
// the reference (tests/test_cascade_properties.py:124). Pad slots
// (val == 0) are skipped by a branch, never multiplied: a filler query's
// pad slot has min = +inf, and 0 * inf = NaN. No atomics on floats, no
// split over slots; results do not depend on docs_blk.
//
// What bounds them on an H100. rwmd: memory traffic; it reads v_r floats of M
// per nonzero slot at stride V+1 (the reference layout (Q, v_r, V+1)), one
// 32-byte sector per lane, 8x the useful bytes; the arithmetic is about v_r
// operations per slot, far below the fp32 rate. lc: latency; it moves
// little (the ELL
// once per query group, one minm line per live slot: about 8 MB at
// paper_5k, Q = 16): its time is the latency of its dependent
// loads along the longest document's chain (140 live slots at paper_5k),
// which the 32 slots in flight a stage shorten. rwmd is a simple first
// version: a vocab-major M is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLcWarps = 4;       // lc: warps a block, whatever Q

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

// Tier 1 on the vocab-major minm, grid (ceil(N / tile), ceil(Q / qg)),
// kLcWarps warps a block, one document a warp at a time; tile is a multiple
// of kLcWarps. Dynamic shared memory: `lc_smem_bytes(qg)`.
__global__ void __launch_bounds__(kLcWarps * kWarp)
lc_rwmd_bound_kernel(const float* __restrict__ minm_vm,  // (vp1, Q)
                     const int* __restrict__ cols,       // (N, nnz)
                     const float* __restrict__ vals,     // (N, nnz)
                     float* __restrict__ lb,             // (Q, N)
                     int q_total, int n, int nnz, int qg, int tile) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = qg + 1;                      // padded: the lanes' rows
  float* s_m = smem + warp * kWarp * (row + 1);  // fall in distinct banks
  float* s_val = s_m + kWarp * row;
  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, q_total - q0);        // queries of this group
  const bool vec = nq == qg && q_total % 4 == 0 &&
                   (reinterpret_cast<size_t>(minm_vm) & 15) == 0;
  const int j_tile = blockIdx.x * tile;
  const int j_end = min(j_tile + tile, n);
  for (int j = j_tile + warp; j < j_end; j += kLcWarps) {
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    // slot s0 + lane of the document; the next stage's slot is loaded
    // while this stage's minm rows are in flight
    int c = lane < nnz ? cj[lane] : 0;
    float v = lane < nnz ? vj[lane] : 0.f;
    float acc = 0.f;
    for (int s0 = 0; s0 < nnz; s0 += kWarp) {
      const unsigned live = __ballot_sync(kFull, v != 0.f);
      float m[kWarp];                          // this slot's minm row
      if (v != 0.f) {
        const float* rowp = minm_vm + (size_t)c * q_total + q0;
        if (vec) {
#pragma unroll
          for (int k = 0; k < kWarp; k += 4)
            if (k < qg) {
              const float4 x = *reinterpret_cast<const float4*>(rowp + k);
              m[k] = x.x;
              m[k + 1] = x.y;
              m[k + 2] = x.z;
              m[k + 3] = x.w;
            }
        } else {
#pragma unroll
          for (int k = 0; k < kWarp; ++k)
            if (k < nq) m[k] = rowp[k];
        }
      }
      const int s = s0 + kWarp + lane;
      const int c_next = s < nnz ? cj[s] : 0;
      const float v_next = s < nnz ? vj[s] : 0.f;
      if (live) {
        s_val[lane] = v;
        if (v != 0.f) {
#pragma unroll
          for (int k = 0; k < kWarp; ++k)
            if (k < nq) s_m[lane * row + k] = m[k];
        }
        __syncwarp();
        // lane q walks the stage's slots in order, up to the last live one
        const int last = kWarp - __clz(live);
        if (lane < nq) {
          for (int t = 0; t < last; ++t) {
            const float val = s_val[t];
            if (val != 0.f)                  // pad slot: never 0 * inf
              acc = bound_step(acc, val, s_m[t * row + lane]);
          }
        }
        __syncwarp();                        // the next stage overwrites
      }
      c = c_next;
      v = v_next;
    }
    if (lane < nq) lb[(size_t)(q0 + lane) * n + j] = acc;
  }
}

// at most 34,816 bytes (qg = 32): under the 48 KB a launch gets unasked
size_t lc_smem_bytes(int qg) {
  return sizeof(float) * (size_t)kLcWarps * kWarp * (qg + 2);
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

extern "C" int lc_rwmd_bound_batch(const void* minm_vm, const void* cols,
                                   const void* vals, void* lb, int q, int n,
                                   int nnz, int docs_blk, void* stream) {
  if (bad_grid(q, n, docs_blk)) return (int)cudaErrorInvalidValue;
  int qg = 1;
  while (qg < q && qg < kWarp) qg <<= 1;
  const int tile = (docs_blk + kLcWarps - 1) / kLcWarps * kLcWarps;
  const dim3 grid((n + tile - 1) / tile, (q + qg - 1) / qg);
  lc_rwmd_bound_kernel<<<grid, kLcWarps * kWarp, lc_smem_bytes(qg),
                         (cudaStream_t)stream>>>(
      (const float*)minm_vm, (const int*)cols, (const float*)vals,
      (float*)lb, q, n, nnz, qg, tile);
  return (int)cudaGetLastError();
}
