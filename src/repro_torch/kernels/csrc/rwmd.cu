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
// with minm[q, c] = min_i M[q, i, c]. Pad query rows carry +inf in M and
// never win the min; an all-pad filler query gives +inf, which the `ops`
// wrappers finite-ize to 0.
//
// Design. Every bound is one walk, `bound_walk`: one warp per document, a
// block of 4 warps walks a tile of documents (docs_blk rounded up to a
// multiple of 4), grid.y counts groups of qg queries. A stage covers 32
// slots of the document, one a lane: lane s loads its slot's col / val
// (coalesced) and, if the slot is live, its slot mins for the qg queries
// of the group into the warp's shared-memory table (rows padded so that
// the lanes' rows fall in distinct banks); the next stage's col / val
// loads are in flight meanwhile. Then lane q walks the stage's slots in
// order, up to the last live one (a ballot skips empty stages), reading
// its min from the table. What differs is where a slot's mins come from:
//
//  * lc (#9) and the dense route of rwmd (#8): from minm laid out
//    vocab-major, (V+1, Q), so one slot's minm for 16 queries is one
//    64-byte line (16-byte loads where the alignment allows); qg = min(next
//    power of two >= Q, 32). `core.cascade.min_cost_vectors` writes minm
//    so for tier 1; the dense route of #8 writes it first with
//    `column_min_kernel`, which reads each (q, row) of M once: a warp takes
//    one query and 256 columns, lane l the columns l, l + 32, ..., so that
//    each load instruction reads one 128-byte stretch of an M row, 4 rows
//    of its 8 columns in flight a lane; the mins leave through a shared
//    tile, transposed, so that the writes are coalesced too.
//  * the gather route of rwmd (#8): from M itself in the reference layout
//    (Q, v_r, V+1), qg = 1: lane s loads the v_r entries of its slot's
//    column, 8 in flight at a time, and reduces them. More in flight costs
//    registers, and occupancy is what this route lives on: 32 in flight
//    (79 registers) ran tier 2 at half the speed of 8 (32 registers).
// `rwmd_bound_batch` takes the dense route when the wrapper hands it a
// scratch minm (`kernels.rwmd.rwmd_route`, a function of shapes alone:
// the ELL's slots against V+1), else the gather route.
//
// Exactness: every bound accumulates in slot order s = 0..nnz-1 through the
// ONE step `bound_step` (an explicitly rounded fma) in the one walk, so no
// contraction can differ between them, and the mins are the same float
// (min is exact; `nan_min` lets a NaN win, as torch.amin and jnp.min): the
// LC bound equals the doc-side bound to the bit on both routes, the
// tier-subsumption property of the reference
// (tests/test_cascade_properties.py:124). Pad slots (val == 0) are skipped
// by a branch, never multiplied: a filler query's pad slot has min = +inf,
// and 0 * inf = NaN. No atomics on floats, no split over slots; results do
// not depend on docs_blk or on the route.
//
// What bounds them on an H100. The dense route is bound by reading M once:
// Q * v_r * (V+1) floats, 205 MB at paper_5k (Q = 16, v_r = 32), 0.061 ms
// at 3.35 TB/s, plus #9's walk. The gather route moves Q * v_r 32-byte
// sectors per live slot (the reference layout puts a column's rows V+1
// floats apart): 8x the useful bytes, through L2; it wins while the
// documents' live slots are few against V+1 (tier 2's 256 documents).
// lc: latency; it moves little (the ELL once per query group, one minm
// line per live slot: about 8 MB at paper_5k, Q = 16): its time is the
// latency of its dependent loads along the longest document's chain (140
// live slots at paper_5k).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkWarps = 4;     // warps a block of the walk, whatever Q
constexpr int kGatherQ = 1;       // gather route: queries a warp
constexpr int kGatherChunk = 8;   // gather route: loads in flight a lane
constexpr int kMinWarps = 8;      // column_min_kernel: warps (queries) a block
constexpr int kMinCols = 8;       // column_min_kernel: columns a lane
constexpr int kMinChunk = 4;      // column_min_kernel: rows in flight

// The one accumulation step of every bound.
__device__ __forceinline__ float bound_step(float acc, float val, float mn) {
  return __fmaf_rn(val, mn, acc);
}

// min that, like jnp.min and torch.amin, keeps a NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// mn[k], k < kCols, = the min over the v_r rows (vp1 floats apart) of the
// column k * step floats past base, read while k * live_step < live (else
// +inf); kChunk rows of every column in flight at once
template <int kCols, int kChunk>
__device__ __forceinline__ void column_mins(const float* __restrict__ base,
                                            size_t step, int v_r, int vp1,
                                            int live, int live_step,
                                            float (&mn)[kCols]) {
#pragma unroll
  for (int k = 0; k < kCols; ++k) mn[k] = INFINITY;
  for (int i0 = 0; i0 < v_r; i0 += kChunk) {
    float x[kCols][kChunk];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
#pragma unroll
      for (int t = 0; t < kChunk; ++t)
        x[k][t] = i0 + t < v_r && k * live_step < live
                      ? base[k * step + (size_t)(i0 + t) * vp1]
                      : INFINITY;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
#pragma unroll
      for (int t = 0; t < kChunk; ++t) mn[k] = nan_min(mn[k], x[k][t]);
  }
}

// A slot's mins from the vocab-major minm (V+1, q_total): m[k] for the
// nq queries q0 + k of the group.
struct MinmRow {
  const float* __restrict__ minm_vm;
  int q_total;
  bool vec;                       // whole group, 16-byte aligned rows

  __device__ __forceinline__ void operator()(int c, int q0, int nq,
                                             float (&m)[kWarp]) const {
    const float* rowp = minm_vm + (size_t)c * q_total + q0;
    if (vec) {
#pragma unroll
      for (int k = 0; k < kWarp; k += 4)
        if (k < nq) {
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
};

// A slot's mins for the nq <= kGatherQ queries q0 + k of the group from M
// in the reference layout (Q, v_r, vp1): the slot's column in each query's
// stripe.
struct MColumn {
  const float* __restrict__ m_pad;
  int v_r, vp1;

  __device__ __forceinline__ void operator()(int c, int q0, int nq,
                                             float (&m)[kGatherQ]) const {
    const size_t stripe = (size_t)v_r * vp1;
    column_mins<kGatherQ, kGatherChunk>(m_pad + q0 * stripe + c, stripe, v_r,
                                        vp1, nq, 1, m);
  }
};

// The walk of every bound (see the header): documents of block x's tile,
// the queries of group y, slot mins from `slot_mins`, kMaxQ >= qg.
// Dynamic shared memory: `walk_smem_bytes(qg)`.
template <int kMaxQ, class SlotMins>
__device__ __forceinline__ void bound_walk(const SlotMins& slot_mins,
                                           const int* __restrict__ cols,
                                           const float* __restrict__ vals,
                                           float* __restrict__ lb,
                                           int q_total, int n, int nnz,
                                           int qg, int tile) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = qg | 1;                      // odd: the lanes' rows fall
  float* s_m = smem + warp * kWarp * (row + 1);  // in distinct banks
  float* s_val = s_m + kWarp * row;
  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, q_total - q0);        // queries of this group
  const int j_tile = blockIdx.x * tile;
  const int j_end = min(j_tile + tile, n);
  for (int j = j_tile + warp; j < j_end; j += kWalkWarps) {
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    // slot s0 + lane of the document; the next stage's slot is loaded
    // while this stage's mins are in flight
    int c = lane < nnz ? cj[lane] : 0;
    float v = lane < nnz ? vj[lane] : 0.f;
    float acc = 0.f;
    for (int s0 = 0; s0 < nnz; s0 += kWarp) {
      const unsigned live = __ballot_sync(kFull, v != 0.f);
      float m[kMaxQ];                          // this slot's mins
      if (v != 0.f) slot_mins(c, q0, nq, m);
      const int s = s0 + kWarp + lane;
      const int c_next = s < nnz ? cj[s] : 0;
      const float v_next = s < nnz ? vj[s] : 0.f;
      if (live) {
        s_val[lane] = v;
        if (v != 0.f) {
#pragma unroll
          for (int k = 0; k < kMaxQ; ++k)
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

// #9 and the dense route's walk, on the vocab-major minm; grid
// (ceil(N / tile), ceil(Q / qg)).
__global__ void __launch_bounds__(kWalkWarps * kWarp)
lc_rwmd_bound_kernel(const float* __restrict__ minm_vm,  // (vp1, Q)
                     const int* __restrict__ cols,       // (N, nnz)
                     const float* __restrict__ vals,     // (N, nnz)
                     float* __restrict__ lb,             // (Q, N)
                     int q_total, int n, int nnz, int qg, int tile) {
  const bool vec = min(qg, q_total - (int)blockIdx.y * qg) == qg &&
                   q_total % 4 == 0 &&
                   (reinterpret_cast<size_t>(minm_vm) & 15) == 0;
  bound_walk<kWarp>(MinmRow{minm_vm, q_total, vec}, cols, vals, lb, q_total,
                    n, nnz, qg, tile);
}

// #8's gather route on M in the reference layout, kGatherQ queries a warp;
// grid (ceil(N / tile), ceil(Q / kGatherQ)).
__global__ void __launch_bounds__(kWalkWarps * kWarp)
rwmd_gather_kernel(const float* __restrict__ m_pad,  // (Q, v_r, vp1)
                   const int* __restrict__ cols,     // (N, nnz)
                   const float* __restrict__ vals,   // (N, nnz)
                   float* __restrict__ lb,           // (Q, N)
                   int q_total, int v_r, int vp1, int n, int nnz, int tile) {
  bound_walk<kGatherQ>(MColumn{m_pad, v_r, vp1}, cols, vals, lb, q_total, n,
                       nnz, kGatherQ, tile);
}

// #8's dense route, first pass: minm_vm[c, q] = min_i M[q, i, c] over
// (Q, v_r, vp1) -> (vp1, Q). Block (x, y) reduces the kMinCols * 32
// columns of tile x for the kMinWarps queries of group y, one query a
// warp: lane l takes the columns l, l + 32, ..., so that each load
// instruction reads one 128-byte stretch of an M row and a warp streams
// kMinCols of them, kMinChunk rows at a time. The mins go through a shared
// tile and leave transposed, the queries of a column adjacent. A warp on
// 32 columns (one 128-byte line a row) ran at less than half the speed.
__global__ void __launch_bounds__(kMinWarps * kWarp)
column_min_kernel(const float* __restrict__ m_pad,
                  float* __restrict__ minm_vm, int q_total, int v_r,
                  int vp1) {
  constexpr int kCols = kMinCols * kWarp;
  __shared__ float tile[kMinWarps][kCols + 1];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int c0 = blockIdx.x * kCols;
  const int q0 = blockIdx.y * kMinWarps;
  const int qn = min(kMinWarps, q_total - q0);
  const int cn = min(kCols, vp1 - c0);
  if (warp < qn) {
    float mn[kMinCols];
    column_mins<kMinCols, kMinChunk>(
        m_pad + (size_t)(q0 + warp) * v_r * vp1 + c0 + lane, kWarp, v_r,
        vp1, cn - lane, kWarp, mn);
#pragma unroll
    for (int k = 0; k < kMinCols; ++k) tile[warp][lane + k * kWarp] = mn[k];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < cn * qn; idx += kMinWarps * kWarp) {
    const int c = idx / qn, q = idx - c * qn;
    minm_vm[(size_t)(c0 + c) * q_total + q0 + q] = tile[q][c];
  }
}

// at most 34,816 bytes (qg = 32): under the 48 KB a launch gets unasked
size_t walk_smem_bytes(int qg) {
  return sizeof(float) * (size_t)kWalkWarps * kWarp * ((qg | 1) + 1);
}

bool bad_grid(int q, int n, int docs_blk) {
  return q <= 0 || n <= 0 || docs_blk <= 0 || q > 65535;
}

int walk_tile(int docs_blk) {
  return (docs_blk + kWalkWarps - 1) / kWalkWarps * kWalkWarps;
}

int launch_column_min(const void* m, void* minm_vm, int q, int v_r, int vp1,
                      cudaStream_t stream) {
  constexpr int kCols = kMinCols * kWarp;
  const dim3 grid((vp1 + kCols - 1) / kCols,
                  (q + kMinWarps - 1) / kMinWarps);
  column_min_kernel<<<grid, kMinWarps * kWarp, 0, stream>>>(
      (const float*)m, (float*)minm_vm, q, v_r, vp1);
  return (int)cudaGetLastError();
}

int launch_lc(const void* minm_vm, const void* cols, const void* vals,
              void* lb, int q, int n, int nnz, int docs_blk,
              cudaStream_t stream) {
  int qg = 1;
  while (qg < q && qg < kWarp) qg <<= 1;
  const int tile = walk_tile(docs_blk);
  const dim3 grid((n + tile - 1) / tile, (q + qg - 1) / qg);
  lc_rwmd_bound_kernel<<<grid, kWalkWarps * kWarp, walk_smem_bytes(qg),
                         stream>>>(
      (const float*)minm_vm, (const int*)cols, (const float*)vals,
      (float*)lb, q, n, nnz, qg, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// #8 on M (Q, v_r, V+1). minm_vm null: the gather route; else the dense
// route, with minm_vm a (V+1, Q) scratch that it fills first.
extern "C" int rwmd_bound_batch(const void* m, const void* cols,
                                const void* vals, void* lb, void* minm_vm,
                                int q, int v_r, int vp1, int n, int nnz,
                                int docs_blk, void* stream) {
  if (bad_grid(q, n, docs_blk) || v_r <= 0 || v_r > 4 * kWarp || vp1 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (minm_vm != nullptr) {
    const int err = launch_column_min(m, minm_vm, q, v_r, vp1, st);
    if (err != 0) return err;
    return launch_lc(minm_vm, cols, vals, lb, q, n, nnz, docs_blk, st);
  }
  const int tile = walk_tile(docs_blk);
  rwmd_gather_kernel<<<dim3((n + tile - 1) / tile,
                            (q + kGatherQ - 1) / kGatherQ),
                       kWalkWarps * kWarp, walk_smem_bytes(kGatherQ), st>>>(
      (const float*)m, (const int*)cols, (const float*)vals, (float*)lb, q,
      v_r, vp1, n, nnz, tile);
  return (int)cudaGetLastError();
}

// The dense route's first pass alone: M (Q, v_r, V+1) -> minm_vm (V+1, Q).
extern "C" int rwmd_column_min(const void* m, void* minm_vm, int q, int v_r,
                               int vp1, void* stream) {
  if (q <= 0 || q > 65535 * kMinWarps || v_r <= 0 || vp1 <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_column_min(m, minm_vm, q, v_r, vp1, (cudaStream_t)stream);
}

extern "C" int lc_rwmd_bound_batch(const void* minm_vm, const void* cols,
                                   const void* vals, void* lb, int q, int n,
                                   int nnz, int docs_blk, void* stream) {
  if (bad_grid(q, n, docs_blk)) return (int)cudaErrorInvalidValue;
  return launch_lc(minm_vm, cols, vals, lb, q, n, nnz, docs_blk,
                   (cudaStream_t)stream);
}
