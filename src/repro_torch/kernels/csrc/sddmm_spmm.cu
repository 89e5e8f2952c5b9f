// Fused SDDMM-SpMM for the Sinkhorn-WMD iteration (type1) and the final
// distance (type2), single-query and batched, sm_90a, plain CUDA C++; and
// the vocab-major copy of the K and K.*M stripes that all four read.
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
// One warp per (q, j); lane l holds query-word rows l, l+32, ... (R rows,
// R = ceil(v_r / 32) <= 4). The K column of a slot is loaded once into
// registers and feeds both the dot (a warp butterfly reduction) and, for
// type1, the accumulation, as the TPU kernel's single VMEM gather does. The
// per-slot arithmetic (`slot_dot_part`, `warp_sum`, `slot_v`,
// `slot_accumulate`, explicitly rounded) is shared by two tiles that differ
// only in where a column comes from and how many slots are in flight:
//
//  * `vm_doc_tile` reads the vocab-major copies (Q, V+1, v_r) of K and of
//    K.*M that `vocab_major_kernel` makes once per stripe set (the solve
//    loop's, the rerank's, one query's pair for the per-query program;
//    never once per launch): a column is one 128-byte line at v_r = 32. A
//    warp lists its document's live slots in shared memory, 32 slots a
//    stage, and walks the list G = 8 / R slots at a time: G column loads in
//    flight (2 G for type2: the K line and the K.*M line of each slot), the
//    G dots summed at once by a reduce-scatter that pairs lanes as
//    `warp_sum` does (the same bits, 9 shuffles instead of 40 at G = 8),
//    one division a lane group, and the G columns folded into acc strictly
//    in slot order. Every serving kernel runs it: #3 where the query-group
//    tile does not, and #1 (`type1_vm_kernel`, #1 at Q = 1 through its own
//    entry), #4 and #2 (`type2_vm_kernel`, #2 at Q = 1 through its own
//    entry).
//  * `group_doc_tile`, the query-group tile, runs #3 at v_r = 32 and
//    Q >= 3 (`type1_vm_kernel_grouped`; the wrapper's `type1_tile` chooses
//    by shape): four queries of one document a warp, eight lanes and four
//    rows a lane each. The document's live slots are staged once for the
//    four queries, a slot's column is one 16-byte load a lane, and of
//    warp_sum's five levels three cross lanes (shared by the four
//    (query, doc) pairs) and two are adds inside a lane: the same bits as
//    the warp tile, which #3's entry takes at any shape when asked for one
//    query a warp (the test-only wrapper `sddmm_spmm_type1_batch_warp`).
//  * `type2_query_kernel` reads K and K.*M in the reference layout
//    (v_r, V+1): a column is v_r floats at stride V+1, one 32-byte sector
//    per lane (8x the useful bytes), one slot at a time. It is the oracle
//    (C entry `sddmm_spmm_type2_naive`): no serving path reaches it; the
//    tests, chip_smoke.py and scripts/bounds_ab.py hold #2 and #4 to it
//    bitwise, an independent kernel with the same per-slot step and the
//    same slot order.
//
// What bounds them on an H100. The arithmetic is 4 flops per row per slot,
// far below the fp32 rate. The oracle is bound by memory traffic. The
// vocab-major tiles move 1/8 of its sectors (the touched K columns are
// about 3.4 MB a query at paper_5k, L2-resident); what is left is the issue
// rate of their per-slot instructions and the latency of each warp's
// chain, which the slots in flight and the reduce-scatter shorten. #3 took
// the same ~1.9-2.0 ns a (query, doc) pair with its ELL in L2 (5,000 docs)
// and in HBM (65,536 and 1,310,720 docs): the SM's instructions a slot, not
// the memory, set its pace. On the warp tile a slot cost about 17 warp
// instructions a pair, 2 of them useful multiply-adds, and five dependent
// shuffle levels; the query-group tile shares the three cross-lane levels,
// the slot list and the division among four pairs and takes 0.50-0.61 of
// the warp tile's time at v_r 32, Q 16 (PERF.md §6). The copy
// moves a whole stripe set once (205 MB read and written for K at Q = 16):
// a tiled transpose at the HBM rate. At Q = 1 (one query's 12.8 MB
// stripes, resident in the 50 MB L2) the work is too small to fill the
// card for long: the longest document's chain (140 live slots) and the
// launch bound #1 and #2.
//
// Exactness: every output element is one warp's fixed-order sum, with no
// atomics and no dependence on docs_blk or on other documents, so the
// port's bitwise contracts (chunked == unchunked, cache on == off) hold,
// #3 equals #1 and #4 equals #2 query by query, and every tile gives the
// same bits. Pad slots (vals == 0) are skipped: they add exactly +0. Pad
// query rows (all-zero K, r = 1) and Q-filler queries (all-zero K, so
// w = 0 and v = val / 1e-30 times a zero column) come out as exact zeros.
// Compiled without --use_fast_math: IEEE division is part of that
// contract.
//
// Reading the iterate (from_x, the Sinkhorn loops' route). The four serving
// entries take a from_x flag. With it set, their u argument is the iterate
// x itself, and `load_u` forms u = 1 / max(x, 1e-30) for the document's
// rows as it loads them, so the loop runs no element-wise pass over the
// (Q, v_r, N) iterate. The bits are those of the element-wise spelling
// (`safe_recip`: clamp, reciprocal and a scale by 1 before each launch; a
// divide by r after each type1):
//   * the max keeps a NaN, as torch.clamp does;
//   * PyTorch's `1.0 / t` is reciprocal(t) * 1.0: one IEEE division, then
//     an exact product;
//   * type1's epilogue already divides by r. On one model shard the program
//     passes the real r, and acc / 1 / r == acc / r. On several shards it
//     passes ones, and the row scale follows the model-axis sum as before.
// The flag is a template parameter. Cleared, every kernel is the code it
// was, instruction for instruction. The Python wrappers count each launch
// with the flag set (`reads_x` in kernels/sddmm_spmm.py); WMDService
// reports a batch's count as last_batch_stats["fused_launches"] and as the
// `fused` attribute of its `solve` span. They count #3's and #1's launches
// by tile too (`tile_launches`).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// -- the per-slot arithmetic every tile shares ------------------------------

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: every lane ends with the same bits (fp add commutes)
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// this lane's share of <a, b> over its R rows
template <int R>
__device__ __forceinline__ float slot_dot_part(const float (&a)[R],
                                               const float (&b)[R]) {
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < R; ++t) part = __fmaf_rn(a[t], b[t], part);
  return part;
}

// val / max(w, TINY), with a max that, like the reference's maximum, keeps
// a NaN
__device__ __forceinline__ float slot_v(float val, float w) {
  return __fdiv_rn(val, w < kTiny ? kTiny : w);
}

template <int R>
__device__ __forceinline__ void slot_accumulate(float (&acc)[R],
                                                const float (&col)[R],
                                                float v) {
#pragma unroll
  for (int t = 0; t < R; ++t) acc[t] = __fmaf_rn(col[t], v, acc[t]);
}

// u = 1 / max(x, TINY), bitwise the program's `safe_recip`: the max keeps a
// NaN as torch.clamp does (fmaxf would drop it), and `1.0 / t` in PyTorch
// is reciprocal(t) * 1.0, one IEEE division and an exact product
__device__ __forceinline__ float recip_x(float x) {
  return __fdiv_rn(1.0f, x < kTiny ? kTiny : x);
}

// the document's u column into registers; kFromX: uq holds the iterate x
// and u is formed from it here (pad rows beyond v_r stay exact zeros)
template <int R, bool kFromX = false>
__device__ __forceinline__ void load_u(float (&uj)[R], float (&acc)[R],
                                       const float* __restrict__ uq, int v_r,
                                       int n, int j) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = lane + t * kWarp;
    if constexpr (kFromX)
      uj[t] = i < v_r ? recip_x(uq[(size_t)i * n + j]) : 0.f;
    else
      uj[t] = i < v_r ? uq[(size_t)i * n + j] : 0.f;
    acc[t] = 0.f;
  }
}

// type1's epilogue: x[:, j] = acc / r
template <int R>
__device__ __forceinline__ void store_x(const float (&acc)[R],
                                        const float* __restrict__ rq,
                                        float* __restrict__ xq, int v_r,
                                        int n, int j) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = lane + t * kWarp;
    if (i < v_r) xq[(size_t)i * n + j] = __fdiv_rn(acc[t], rq[i]);
  }
}

// type2's epilogue: wmd[j] = <u[:, j], acc>
template <int R>
__device__ __forceinline__ void store_d(const float (&uj)[R],
                                        const float (&acc)[R],
                                        float* __restrict__ outq, int j) {
  const float d = warp_sum(slot_dot_part<R>(uj, acc));
  if (threadIdx.x % kWarp == 0) outq[j] = d;
}

// -- reference layout: the oracle of #2 and #4 -------------------------------

// The single-query type2 grid, ceil(N / docs_blk) blocks, one warp per
// document, K and K.*M in the reference layout: (v_r, vp1) stripes,
// u (v_r, N) -> wmd (N). No serving path launches it.
template <int R>
__global__ void type2_query_kernel(const float* __restrict__ kq,
                                   const float* __restrict__ kmq,
                                   const float* __restrict__ uq,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ vals,
                                   float* __restrict__ wmd, int v_r, int vp1,
                                   int n, int nnz, int docs_blk) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int j0 = blockIdx.x * docs_blk;
  const int j_end = min(j0 + docs_blk, n);
  for (int j = j0 + warp; j < j_end; j += warps) {
    float uj[R], acc[R];
    load_u<R>(uj, acc, uq, v_r, n, j);
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    for (int s = 0; s < nnz; ++s) {
      const float val = vj[s];
      if (val == 0.f) continue;              // pad slot: adds exactly +0
      const size_t c = (size_t)cj[s];
      float kc[R], kmc[R];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        kc[t] = i < v_r ? kq[(size_t)i * vp1 + c] : 0.f;
        kmc[t] = i < v_r ? kmq[(size_t)i * vp1 + c] : 0.f;
      }
      slot_accumulate<R>(acc, kmc,
                         slot_v(val, warp_sum(slot_dot_part<R>(kc, uj))));
    }
    store_d<R>(uj, acc, wmd, j);
  }
}

// -- vocab-major: #3, #1, #4, #2 and the copy -------------------------------

// The G slots' warp sums at once (G a power of two <= 32): a reduce-scatter
// that pairs lanes exactly as warp_sum's butterfly does (own + partner's at
// xor distance 16, 8, ..., 1), so every slot's sum has warp_sum's bits. The
// first log2(G) levels halve the slots a lane carries instead of
// duplicating them; lane l ends with the sum of slot l >> (5 - log2 G).
// G - 1 + 5 - log2(G) shuffles instead of 5 G.
template <int G>
__device__ __forceinline__ float warp_sum_scatter(float (&p)[G]) {
  const int lane = threadIdx.x % kWarp;
  int off = kWarp / 2;
#pragma unroll
  for (int m = G; m > 1; m >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < m / 2; ++k) {
      const float keep = upper ? p[k + m / 2] : p[k];
      const float send = upper ? p[k] : p[k + m / 2];
      p[k] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  float x = p[0];
#pragma unroll
  for (; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// One query's documents j0 .. j_end-1 on the vocab-major copies, one warp a
// document. The warp loads its document's slots 32 at a time (one
// coalesced load of cols and of vals, a slot a lane) and compacts the live
// ones, in slot order, into its shared-memory list sc / sv (pad slots, val
// 0, add exactly +0 and are dropped). It then walks the list G = 8 / R
// slots at a time: G K-line loads (and, for type2, G K.*M-line loads) in
// flight, the G dots reduced at once (`warp_sum_scatter`), lane group g
// computing slot g's v, and the G columns (K's for type1, K.*M's for
// type2) folded into acc in slot order. Pointers are the query's own:
// kq / kmq (vp1, v_r), rq (v_r), uq (v_r, n), outq x (v_r, n) or wmd (n).
// kFromX: uq is the iterate x, and u = `recip_x`(x) is formed in `load_u`.
template <int R, bool kType2, bool kFromX>
__device__ __forceinline__ void vm_doc_tile(
    const float* __restrict__ kq, const float* __restrict__ kmq,
    const float* __restrict__ rq, const float* __restrict__ uq,
    const int* __restrict__ cols, const float* __restrict__ vals,
    float* __restrict__ outq, int* sc, float* sv, int v_r, int n, int nnz,
    int j0, int j_end) {
  constexpr int G = 8 / R;
  constexpr int kShift = 5 - log2i(G);       // lane >> kShift: its slot
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int my_g = lane >> kShift;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  for (int j = j0 + warp; j < j_end; j += warps) {
    float uj[R], acc[R];
    load_u<R, kFromX>(uj, acc, uq, v_r, n, j);
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    for (int s0 = 0; s0 < nnz; s0 += kWarp) {
      const int s = s0 + lane;
      const int c = s < nnz ? cj[s] : 0;
      const float val = s < nnz ? vj[s] : 0.f;
      const unsigned live = __ballot_sync(kFull, val != 0.f);
      const int count = __popc(live);
      if (val != 0.f) {
        const int at = __popc(live & below);
        sc[at] = c;
        sv[at] = val;
      }
      __syncwarp();
      for (int k = 0; k < count; k += G) {
        float col[G][R], mcol[G][R], part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const bool ok = k + g < count;
          const size_t cc = ok ? (size_t)sc[k + g] : 0;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const int i = lane + t * kWarp;
            const bool in = ok && i < v_r;
            col[g][t] = in ? kq[cc * v_r + i] : 0.f;
            if constexpr (kType2) mcol[g][t] = in ? kmq[cc * v_r + i] : 0.f;
          }
          part[g] = slot_dot_part<R>(col[g], uj);
        }
        const float w = warp_sum_scatter<G>(part);
        const int mine = k + my_g;
        const float v_mine = mine < count ? slot_v(sv[mine], w) : 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float v = __shfl_sync(kFull, v_mine, g << kShift);
          if (k + g < count) {
            if constexpr (kType2)
              slot_accumulate<R>(acc, mcol[g], v);
            else
              slot_accumulate<R>(acc, col[g], v);
          }
        }
      }
      __syncwarp();                          // the next stage overwrites
    }
    if constexpr (kType2)
      store_d<R>(uj, acc, outq, j);
    else
      store_x<R>(acc, rq, outq, v_r, n, j);
  }
}

// The query-group tile of #3, at v_r = 32 only: kGroupQ = 4 queries
// q0 .. q0 + 3 of one document a warp, L = 8 lanes a query, lane l of group
// g holding rows 4 l .. 4 l + 3 of query q0 + g. The warp stages its
// document's live slots as `vm_doc_tile` does, once for all four groups,
// and walks the list kGroupSlots = 4 slots at a time: each slot's column is
// one 16-byte load a lane, which fills each query's 128-byte line. Row
// i = 4 l + t, so warp_sum's levels at rows 16, 8 and 4 apart pair lanes
// l ^ 4, l ^ 2 and l ^ 1 of the group: the first two run as a
// reduce-scatter over the 4 slots, as in `warp_sum_scatter`, the third as
// warp_sum's butterfly, so lanes 2 s and 2 s + 1 end with slot s's sums of
// their 4 rows. The levels 2 and 1 are then adds inside the lane, in that
// order: every slot's w has warp_sum's bits. One division a lane gives its
// slot's v, one shuffle of width 8 hands slot s's v to all four groups at
// once, and the 4 columns are folded into acc in slot order. A group past Q
// (the last group of a Q not a multiple of 4) reads query Q - 1 and stores
// nothing. kvm (Q, vp1, 32) 16-byte aligned, r (Q, 32), u and x (Q, 32,
// n); kFromX: u holds the iterate x.
//
// Four slots a step and at least kGroupMinBlocks blocks an SM (48
// registers a thread) came out fastest of 2 or 4 queries a warp, 2, 4 or 8
// slots a step and 1 to 8 blocks an SM on an H100 (PERF.md §6): the
// tile waits on each step's chain, and more warps hide it better than more
// slots in flight.
constexpr int kGroupQ = 4;
constexpr int kGroupSlots = 4;
constexpr int kGroupMinBlocks = 5;

// a lane's four rows of a column, one 16-byte load
__device__ __forceinline__ void load_rows(float (&col)[kGroupQ],
                                          const float* __restrict__ p) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  col[0] = c.x, col[1] = c.y, col[2] = c.z, col[3] = c.w;
}

// The G slots' sums over a group's lanes, levels D, D/2, ..., 1 lanes
// apart (rows P D, ..., P apart), M the slots a lane still carries: while
// M > 1 the upper lane of a pair keeps the upper half of them, as in
// warp_sum_scatter, then both lanes of a pair add the same two values, as
// warp_sum does. Lane l ends with slot l / (L / G)'s P row sums in p[0].
// Template recursion keeps every index a constant.
template <int D, int M, int G, int P>
__device__ __forceinline__ void group_scatter(float (&p)[G][P], int l) {
  if constexpr (D > 0) {
    if constexpr (M > 1) {
      const bool upper = l & D;
#pragma unroll
      for (int g = 0; g < M / 2; ++g) {
#pragma unroll
        for (int t = 0; t < P; ++t) {
          const float keep = upper ? p[g + M / 2][t] : p[g][t];
          const float send = upper ? p[g][t] : p[g + M / 2][t];
          p[g][t] = keep + __shfl_xor_sync(kFull, send, D);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < P; ++t)
        p[0][t] += __shfl_xor_sync(kFull, p[0][t], D);
    }
    group_scatter<D / 2, (M > 1 ? M / 2 : 1), G, P>(p, l);
  }
}

// The levels H, H/2, ..., 1 rows apart inside a lane: s[0] ends with the
// sum of the lane's rows
template <int H, int P>
__device__ __forceinline__ void lane_sum(float (&s)[P]) {
  if constexpr (H > 0) {
#pragma unroll
    for (int t = 0; t < H; ++t) s[t] += s[t + H];
    lane_sum<H / 2, P>(s);
  }
}

template <bool kFromX>
__device__ __forceinline__ void group_doc_tile(
    const float* __restrict__ kvm, const float* __restrict__ r,
    const float* __restrict__ u, const int* __restrict__ cols,
    const float* __restrict__ vals, float* __restrict__ x, int* sc,
    float* sv, int q, int q0, int vp1, int n, int nnz, int j0, int j_end) {
  constexpr int P = kGroupQ;                 // queries a warp, rows a lane
  constexpr int G = kGroupSlots;             // slots a step
  constexpr int L = kWarp / P;               // lanes a query
  constexpr int kShift = log2i(L / G);       // l >> kShift: the lane's slot
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int l = lane % L;
  const int qg = q0 + lane / L;
  const bool real = qg < q;
  const size_t qq = real ? qg : q - 1;
  const float* kq = kvm + qq * vp1 * kWarp + P * l;
  const float* rq = r + qq * kWarp + P * l;
  const float* uq = u + (qq * kWarp + P * l) * n;
  float* xq = x + (qq * kWarp + P * l) * n;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  for (int j = j0 + warp; j < j_end; j += warps) {
    const int* cj = cols + (size_t)j * nnz;
    const float* vj = vals + (size_t)j * nnz;
    // the first stage's slots are on their way while u is formed, and each
    // next stage's while the warp walks this one
    int c_next = lane < nnz ? cj[lane] : 0;
    float val_next = lane < nnz ? vj[lane] : 0.f;
    float uj[P], acc[P];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const float ut = uq[(size_t)t * n + j];
      uj[t] = kFromX ? recip_x(ut) : ut;
      acc[t] = 0.f;
    }
    for (int s0 = 0; s0 < nnz; s0 += kWarp) {
      const int c = c_next;
      const float val = val_next;
      const int s = s0 + kWarp + lane;
      c_next = s < nnz ? cj[s] : 0;
      val_next = s < nnz ? vj[s] : 0.f;
      const unsigned live = __ballot_sync(kFull, val != 0.f);
      const int count = __popc(live);
      if (val != 0.f) {
        const int at = __popc(live & below);
        sc[at] = c;
        sv[at] = val;
      }
      __syncwarp();
      for (int k = 0; k < count; k += G) {
        float col[G][P], p[G][P];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (k + g < count) {
            load_rows(col[g], kq + (size_t)sc[k + g] * kWarp);
          } else {
#pragma unroll
            for (int t = 0; t < P; ++t) col[g][t] = 0.f;
          }
          // slot_dot_part's product, row by row: an fma with +0
#pragma unroll
          for (int t = 0; t < P; ++t)
            p[g][t] = __fmaf_rn(col[g][t], uj[t], 0.f);
        }
        group_scatter<L / 2, G, G, P>(p, l);  // rows 16, ..., P apart
        lane_sum<P / 2, P>(p[0]);             // rows P / 2, ..., 1 apart
        const int mine = k + (l >> kShift);
        const float v_mine = mine < count ? slot_v(sv[mine], p[0][0]) : 0.f;
        // a slot past the list has a zero column and v = 0: fma(0, 0, acc)
        // is acc, bit for bit (acc is never -0), so no test is needed
#pragma unroll
        for (int g = 0; g < G; ++g)
          slot_accumulate<P>(acc, col[g],
                             __shfl_sync(kFull, v_mine, g << kShift, L));
      }
      __syncwarp();                          // the next stage overwrites
    }
    if (real) {
#pragma unroll
      for (int t = 0; t < P; ++t)
        xq[(size_t)t * n + j] = __fdiv_rn(acc[t], rq[t]);
    }
  }
}

// #3 on the query-group tile, the grid (ceil(N / docs_blk), ceil(Q / 4)):
// block (tile, group) walks queries 4 group .. 4 group + 3 of its tile.
template <bool kFromX>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * kWarp, kGroupMinBlocks)
type1_vm_kernel_grouped(const float* __restrict__ kvm,   // (Q, vp1, 32)
                        const float* __restrict__ r,     // (Q, 32)
                        const float* __restrict__ u,     // (Q, 32, N)
                        const int* __restrict__ cols,    // (N, nnz)
                        const float* __restrict__ vals,  // (N, nnz)
                        float* __restrict__ x,           // (Q, 32, N)
                        int q, int vp1, int n, int nnz, int docs_blk) {
  __shared__ int s_col[kMaxWarpsPerBlock][kWarp];
  __shared__ float s_val[kMaxWarpsPerBlock][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int j0 = blockIdx.x * docs_blk;
  group_doc_tile<kFromX>(kvm, r, u, cols, vals, x, s_col[warp], s_val[warp],
                         q, blockIdx.y * kGroupQ, vp1, n, nnz, j0,
                         min(j0 + docs_blk, n));
}

// #3 (and #1 at Q = 1), the type1 grid (ceil(N / docs_blk), Q) on the
// vocab-major copy of K: block (tile, q) walks query q's documents of its
// tile. kFromX: u holds the iterate x (`load_u`).
template <int R, bool kFromX>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * kWarp)
type1_vm_kernel(const float* __restrict__ kvm,   // (Q, vp1, v_r)
                const float* __restrict__ r,     // (Q, v_r)
                const float* __restrict__ u,     // (Q, v_r, N): u, or x
                const int* __restrict__ cols,    // (N, nnz)
                const float* __restrict__ vals,  // (N, nnz)
                float* __restrict__ x,           // (Q, v_r, N)
                int v_r, int vp1, int n, int nnz, int docs_blk) {
  __shared__ int s_col[kMaxWarpsPerBlock][kWarp];
  __shared__ float s_val[kMaxWarpsPerBlock][kWarp];
  const size_t q = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int j0 = blockIdx.x * docs_blk;
  vm_doc_tile<R, false, kFromX>(kvm + q * vp1 * v_r, nullptr, r + q * v_r,
                                u + q * v_r * n, cols, vals, x + q * v_r * n,
                                s_col[warp], s_val[warp], v_r, n, nnz, j0,
                                min(j0 + docs_blk, n));
}

// #4 (and #2 at Q = 1), the type2 grid (ceil(N / docs_blk), Q) on the
// vocab-major copies of K and K.*M. kFromX: u holds the iterate x.
template <int R, bool kFromX>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * kWarp)
type2_vm_kernel(const float* __restrict__ kvm,   // (Q, vp1, v_r)
                const float* __restrict__ kmvm,  // (Q, vp1, v_r)
                const float* __restrict__ u,     // (Q, v_r, N): u, or x
                const int* __restrict__ cols,    // (N, nnz)
                const float* __restrict__ vals,  // (N, nnz)
                float* __restrict__ wmd,         // (Q, N)
                int v_r, int vp1, int n, int nnz, int docs_blk) {
  __shared__ int s_col[kMaxWarpsPerBlock][kWarp];
  __shared__ float s_val[kMaxWarpsPerBlock][kWarp];
  const size_t q = blockIdx.y;
  const size_t stripe = (size_t)vp1 * v_r;
  const int warp = threadIdx.x / kWarp;
  const int j0 = blockIdx.x * docs_blk;
  vm_doc_tile<R, true, kFromX>(kvm + q * stripe, kmvm + q * stripe, nullptr,
                               u + q * v_r * n, cols, vals, wmd + q * n,
                               s_col[warp], s_val[warp], v_r, n, nnz, j0,
                               min(j0 + docs_blk, n));
}

// (B, rows, cols) -> (B, cols, rows) through 32 x 32 tiles in shared
// memory, reads along cols and writes along rows both coalesced: the K (or
// K.*M) stripes (Q, v_r, V+1) -> the vocab-major copy (Q, V+1, v_r). Block
// (x, y, z), of kWarp x kTileRows threads, moves tile (x, y) of batch z.
constexpr int kTileRows = 8;

__global__ void vocab_major_kernel(const float* __restrict__ src,
                                   float* __restrict__ dst, int rows,
                                   int cols) {
  __shared__ float tile[kWarp][kWarp + 1];
  const size_t off = (size_t)blockIdx.z * rows * cols;
  const int c0 = blockIdx.x * kWarp;
  const int r0 = blockIdx.y * kWarp;
  for (int dy = threadIdx.y; dy < kWarp; dy += kTileRows) {
    const int rr = r0 + dy, cc = c0 + threadIdx.x;
    if (rr < rows && cc < cols)
      tile[dy][threadIdx.x] = src[off + (size_t)rr * cols + cc];
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < kWarp; dy += kTileRows) {
    const int cc = c0 + dy, rr = r0 + threadIdx.x;
    if (cc < cols && rr < rows)
      dst[off + (size_t)cc * rows + rr] = tile[threadIdx.x][dy];
  }
}

// -- launchers ---------------------------------------------------------------

bool bad_shape(int q, int v_r, int n, int docs_blk) {
  return q <= 0 || q > 65535 || n <= 0 || v_r <= 0 || v_r > 4 * kWarp ||
         docs_blk <= 0;
}

dim3 tile_grid(int n, int docs_blk, int q) {
  return dim3((n + docs_blk - 1) / docs_blk, q);
}

dim3 tile_block(int docs_blk) {
  return dim3((docs_blk < kMaxWarpsPerBlock ? docs_blk : kMaxWarpsPerBlock) *
              kWarp);
}

// Calls launch(std::integral_constant<int, R>) with the rows a lane holds,
// R = ceil(v_r / 32) rounded up to 1, 2 or 4; returns the launch's error.
template <typename Launch>
int by_rows(int v_r, Launch launch) {
  const int rows = (v_r + kWarp - 1) / kWarp;
  if (rows == 1)
    launch(std::integral_constant<int, 1>{});
  else if (rows == 2)
    launch(std::integral_constant<int, 2>{});
  else
    launch(std::integral_constant<int, 4>{});
  return (int)cudaGetLastError();
}

// by_rows, and the kFromX instance: launch(rows, from_x) with both as
// std::integral_constant
template <typename Launch>
int by_rows_from_x(int v_r, int from_x, Launch launch) {
  return by_rows(v_r, [&](auto rows) {
    if (from_x)
      launch(rows, std::true_type{});
    else
      launch(rows, std::false_type{});
  });
}

int launch_type1_vm(const void* kvm, const void* r, const void* u,
                    const void* cols, const void* vals, void* x, int q,
                    int v_r, int vp1, int n, int nnz, int docs_blk,
                    int from_x, void* stream) {
  if (bad_shape(q, v_r, n, docs_blk)) return (int)cudaErrorInvalidValue;
  const dim3 grid = tile_grid(n, docs_blk, q), block = tile_block(docs_blk);
  return by_rows_from_x(v_r, from_x, [&](auto rows, auto fx) {
    type1_vm_kernel<decltype(rows)::value, decltype(fx)::value>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)kvm, (const float*)r, (const float*)u,
            (const int*)cols, (const float*)vals, (float*)x, v_r, vp1, n,
            nnz, docs_blk);
  });
}

// #3 on the query-group tile: v_r 32, kvm 16-byte aligned (the kernel
// loads a lane's rows as one vector)
int launch_type1_grouped(const void* kvm, const void* r, const void* u,
                         const void* cols, const void* vals, void* x, int q,
                         int v_r, int vp1, int n, int nnz, int docs_blk,
                         int from_x, void* stream) {
  if (bad_shape(q, v_r, n, docs_blk) || v_r != kWarp ||
      reinterpret_cast<size_t>(kvm) % sizeof(float4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = tile_grid(n, docs_blk, (q + kGroupQ - 1) / kGroupQ);
  const dim3 block = tile_block(docs_blk);
  auto launch = [&](auto fx) {
    type1_vm_kernel_grouped<decltype(fx)::value>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)kvm, (const float*)r, (const float*)u,
            (const int*)cols, (const float*)vals, (float*)x, q, vp1, n, nnz,
            docs_blk);
  };
  if (from_x)
    launch(std::true_type{});
  else
    launch(std::false_type{});
  return (int)cudaGetLastError();
}

int launch_type2_vm(const void* kvm, const void* kmvm, const void* u,
                    const void* cols, const void* vals, void* wmd, int q,
                    int v_r, int vp1, int n, int nnz, int docs_blk,
                    int from_x, void* stream) {
  if (bad_shape(q, v_r, n, docs_blk)) return (int)cudaErrorInvalidValue;
  const dim3 grid = tile_grid(n, docs_blk, q), block = tile_block(docs_blk);
  return by_rows_from_x(v_r, from_x, [&](auto rows, auto fx) {
    type2_vm_kernel<decltype(rows)::value, decltype(fx)::value>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)kvm, (const float*)kmvm, (const float*)u,
            (const int*)cols, (const float*)vals, (float*)wmd, v_r, vp1, n,
            nnz, docs_blk);
  });
}

}  // namespace

// The four serving entries take from_x last before the stream: 0, u is
// the Sinkhorn u; 1, u holds the iterate x, and the kernel forms
// u = 1 / max(x, TINY) as it loads it (`recip_x`).

// #3 on the vocab-major copy kvm (Q, V+1, v_r), on the doc tile the
// wrapper chose by shape (`type1_tile` in kernels/sddmm_spmm.py): queries
// 1, the warp tile; 4, the query-group tile (v_r 32 only).
extern "C" int sddmm_spmm_type1_batch(const void* kvm, const void* r,
                                      const void* u, const void* cols,
                                      const void* vals, void* x, int q,
                                      int v_r, int vp1, int n, int nnz,
                                      int docs_blk, int queries, int from_x,
                                      void* stream) {
  if (queries == 1)
    return launch_type1_vm(kvm, r, u, cols, vals, x, q, v_r, vp1, n, nnz,
                           docs_blk, from_x, stream);
  if (queries != kGroupQ) return (int)cudaErrorInvalidValue;
  return launch_type1_grouped(kvm, r, u, cols, vals, x, q, v_r, vp1, n, nnz,
                              docs_blk, from_x, stream);
}

// #1: #3's kernel at Q = 1 on one query's vocab-major copy kvm (V+1, v_r),
// r (v_r), u and x (v_r, N); an entry of its own so that its launches are
// counted apart from #3's.
extern "C" int sddmm_spmm_type1(const void* kvm, const void* r, const void* u,
                                const void* cols, const void* vals, void* x,
                                int v_r, int vp1, int n, int nnz,
                                int docs_blk, int from_x, void* stream) {
  return launch_type1_vm(kvm, r, u, cols, vals, x, 1, v_r, vp1, n, nnz,
                         docs_blk, from_x, stream);
}

// #4 on the vocab-major copies kvm, kmvm (Q, V+1, v_r).
extern "C" int sddmm_spmm_type2_batch(const void* kvm, const void* kmvm,
                                      const void* u, const void* cols,
                                      const void* vals, void* wmd, int q,
                                      int v_r, int vp1, int n, int nnz,
                                      int docs_blk, int from_x,
                                      void* stream) {
  return launch_type2_vm(kvm, kmvm, u, cols, vals, wmd, q, v_r, vp1, n, nnz,
                         docs_blk, from_x, stream);
}

// #2: #4's kernel at Q = 1 on one query's vocab-major copies kvm, kmvm
// (V+1, v_r), u (v_r, N) -> wmd (N); an entry of its own so that its
// launches are counted apart from #4's.
extern "C" int sddmm_spmm_type2(const void* kvm, const void* kmvm,
                                const void* u, const void* cols,
                                const void* vals, void* wmd, int v_r,
                                int vp1, int n, int nnz, int docs_blk,
                                int from_x, void* stream) {
  return launch_type2_vm(kvm, kmvm, u, cols, vals, wmd, 1, v_r, vp1, n, nnz,
                         docs_blk, from_x, stream);
}

// The oracle of #2 and #4: one query's reference-layout stripes k, km
// (v_r, V+1), one slot at a time.
extern "C" int sddmm_spmm_type2_naive(const void* k, const void* km,
                                      const void* u, const void* cols,
                                      const void* vals, void* wmd, int v_r,
                                      int vp1, int n, int nnz, int docs_blk,
                                      void* stream) {
  if (bad_shape(1, v_r, n, docs_blk)) return (int)cudaErrorInvalidValue;
  const dim3 grid = tile_grid(n, docs_blk, 1), block = tile_block(docs_blk);
  return by_rows(v_r, [&](auto rows) {
    type2_query_kernel<decltype(rows)::value>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)k, (const float*)km, (const float*)u,
            (const int*)cols, (const float*)vals, (float*)wmd, v_r, vp1, n,
            nnz, docs_blk);
  });
}

// The vocab-major copy: src (b, rows, cols) -> dst (b, cols, rows).
extern "C" int k_vocab_major(const void* src, void* dst, int b, int rows,
                             int cols, void* stream) {
  if (b <= 0 || b > 65535 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kWarp - 1) / kWarp, (rows + kWarp - 1) / kWarp, b);
  vocab_major_kernel<<<grid, dim3(kWarp, kTileRows), 0,
                       (cudaStream_t)stream>>>((const float*)src,
                                               (float*)dst, rows, cols);
  return (int)cudaGetLastError();
}
