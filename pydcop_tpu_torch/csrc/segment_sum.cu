// MaxSum belief aggregation: per variable, the sum of its incoming
// factor->variable messages, in a FIXED order, and the beliefs.
//
// Replaces the scatter branch of pydcop_tpu/ops/maxsum.py:389
// (aggregate_beliefs): one segment_sum per bucket, added up.  That is
// jnp code, not a Pallas kernel; it became a hand kernel because the
// card's index_add_ adds with atomics in no fixed order, so the sums'
// last bits, and with them near-tied argmins and the whole MaxSum
// trajectory, changed from run to run and differed from the reference.
//
// The order is part of the contract.  Within a bucket, a variable's
// edges are added one at a time in edge order ((factor, position)
// order), starting from +0.0f.  Across buckets it is the form XLA gives
// the reference's jitted ((0 + S0) + S1) + S2 + ...: bucket 0 starts
// the running sum; a bucket whose bit is set in `sep` (the wrapper's
// separate_buckets: odd buckets, unless XLA merged them into the
// scatter before) is summed from +0.0f on its own and then added to
// it; any other bucket is added into it edge by edge.  The one_sum mode
// (the reference's `sorted` aggregation: one
// segment_sum over the edges gathered into CSR order) adds every edge of
// every bucket into the one running sum instead.  Then beliefs =
// var_costs + sums.  Every add is one fadd_ftz (add.rn.ftz.f32: a
// subnormal result is flushed to zero, as XLA:CPU flushes the
// reference's) in that order, so the sums equal the plain version
// (segment_sum_reference, the same walk with each add flushed) and the
// reference's jitted superstep bit for bit.  No tree or shuffle reduction and no atomics touch a sum.
//
// The same file holds the local search's positional sum (below the
// belief kernels): its candidate costs, summed in the reference's order.
//
// A variable's edges are perm[offsets[v]] .. perm[offsets[v + 1] - 1]
// (a stable sort of the edges by variable, built at placement by
// device.aggregation_arrays); edge p belongs to bucket b when
// start[b] <= p < start[b + 1].  The messages are read where they lie:
// bucket b's f2v tensor starts at base[b], and edge p of it is the row
// base[b] + (p - start[b]) * D.  Bases and starts come by value in the
// kernel's parameters (no device array, no copy per call).
//
// Layout: messages [E_b, D] float32 per bucket (the [F, arity, D]
// tensors as they are), perm [E] int32, offsets [V+2] int32, tiles
// [T, 4] int32, var_costs [V+1, D] float32; sums and beliefs [V+1, D]
// float32 out (allocated by the wrapper).  The sentinel row V sums the
// padding edges like any other row.
//
// Bound: memory.  Per call it must read E*D*4 (messages) + E*4 (perm)
// + (V+2)*4 (offsets) + (V+1)*D*4 (var_costs) bytes and write
// 2*(V+1)*D*4: ~0.88 MB for the 10k-variable flagship (launch-bound)
// and ~88 MB for the 1M-variable scale graph (~26 us at 3.35 TB/s).
// The messages are read through the permutation, one 12-byte row per
// edge at D = 3, so a random graph reads whole 32-byte sectors: about
// 1.25 sectors a row, ~120 MB at the scale graph, which is what bounds
// this kernel there.  The 50 MB L2 does not keep the 36 MB message
// array against the rest of the traffic (an evict-last policy on the
// rows gained nothing on the H100); a plain gather of the same rows in
// edge order (index_select) takes about as long as this whole kernel.
//
// Design.  The placement plan (ops/segment_sum.py aggregation_plan)
// cuts the variables into tiles, one block each: first the heavy
// variables (degree above a threshold), each a tile of its own, largest
// first, so their long add chains start first and overlap the rest;
// then light tiles of consecutive variables, at most 256 / D of them
// and (normally) at most one pass of edges.  A tile's edges are one
// contiguous slice of perm.  Per pass of at most `chunk` edges:
//   1. gather: each thread takes whole edges of the slice, reads their
//      perm entries (coalesced), then loads their message rows into
//      registers (all loads issued before the first use; the row's
//      widest aligned vector: float4 / float2 when D and every base
//      allow it, else floats) and stores them in CSR order into shared
//      memory, so the SM has as many misses in flight as the block has
//      edges instead of one dependent chain per thread;
//   2. add: thread (v, d) adds its variable's edges of this pass from
//      shared memory, one fadd_ftz at a time, carrying the running
//      sum, the separate bucket's own sum and the bucket index in
//      registers from one pass to the next, so the order is the one-pass
//      order.
// perm, offsets, tiles and var_costs are read and sums and beliefs
// written once, with evict-first hints (__ldcs / __stcs), so they push
// fewer message rows out of L2.
// The pass loop is what lets a heavy variable of any degree go through
// shared memory; its serial part is one FADD chain.  Double-buffering
// the passes (cp.async into the next buffer while adding) was left out:
// light tiles take one pass; only heavy tiles take more, and they are
// few and overlap the light ones.  TMA does not fit a gather of 12-byte
// rows.
// D = 1..8 is templated (rows in registers, 256 / D variables a tile);
// above 8 a generic kernel takes one thread per (variable, d) and walks
// the edges itself, as the first version of this kernel did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the plan's tile width is kThreads / D
constexpr int kMaxBuckets = 64;
constexpr int kUnroll = 4;         // edges a thread gathers per round
constexpr int kMaxTiledD = 8;

// Float adds as PTX with .ftz: a subnormal result (or
// input) is flushed to a zero of its sign, as XLA:CPU and the TPU do for
// the reference; inline asm is never contracted or reordered by nvcc.
__device__ __forceinline__ float fadd_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Buckets {
  const float* base[kMaxBuckets];
  int start[kMaxBuckets + 1];
  int n;
  unsigned long long sep;  // bit b: bucket b summed on its own, then added
};

__device__ __forceinline__ bool separate(unsigned long long sep, int b) {
  return (sep >> b) & 1ull;
}

template <int W> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

// Leave buckets until `to` (edges come in bucket order): leaving a
// separate bucket adds its own sum into the running sum.  After the last
// edge every remaining bucket is left, so each separate bucket's sum is
// added to every variable (+0.0 where it has no edge there), as the
// reference adds whole arrays: a flushed -0.0 sum then becomes +0.0.
__device__ __forceinline__ void leave_buckets(int& b, int to, float& acc,
                                              float& part,
                                              unsigned long long sep) {
  while (b < to) {
    if (separate(sep, b)) {
      acc = fadd_ftz(acc, part);
      part = 0.0f;
    }
    ++b;
  }
}

template <bool kMulti>
__device__ __forceinline__ void add_edge(float m, int eb, float& acc,
                                         float& part, int& b,
                                         unsigned long long sep) {
  if (!kMulti) {
    acc = fadd_ftz(acc, m);
    return;
  }
  if (eb != b) leave_buckets(b, eb, acc, part, sep);
  if (separate(sep, b)) {
    part = fadd_ftz(part, m);
  } else {
    acc = fadd_ftz(acc, m);
  }
}

// Add edges [e, e_end) of a pass out of shared memory (m: this slot's
// column, stride D; bkt: each edge's bucket), one fadd_ftz at a time
// in edge order.  With several buckets the per-edge bucket test would
// keep each edge's two shared loads from running ahead of the adds, so
// the loads go in batches of kBatch, the next batch's issued before
// the current one's adds: a long chain (a heavy variable) then waits
// on the FADD latency.  One bucket takes the plain loop, which the
// compiler unrolls itself; batching it too cost registers (one block
// less per SM) and measured slower on the H100, light tiles included.
constexpr int kBatch = 8;

template <int D, bool kMulti>
__device__ __forceinline__ void add_edges(const float* m,
                                          const uint8_t* bkt, int e,
                                          int e_end, float& acc,
                                          float& part, int& b,
                                          unsigned long long sep) {
  if constexpr (kMulti) {
    if (e + kBatch <= e_end) {
      float v[kBatch];
      int q[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        v[j] = m[(e + j) * D];
        q[j] = bkt[e + j];
      }
      for (e += kBatch; e + kBatch <= e_end; e += kBatch) {
        float vn[kBatch];
        int qn[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          vn[j] = m[(e + j) * D];
          qn[j] = bkt[e + j];
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          add_edge<true>(v[j], q[j], acc, part, b, sep);
          v[j] = vn[j];
          q[j] = qn[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        add_edge<true>(v[j], q[j], acc, part, b, sep);
      }
    }
  }
  for (; e < e_end; ++e) {
    add_edge<kMulti>(m[e * D], kMulti ? bkt[e] : 0, acc, part, b, sep);
  }
}

// One block per tile (v_lo, v_hi, e_lo, e_hi); W floats per load.
// kMulti = false: one bucket, every edge adds into the running sum.
// kMulti = true: several buckets, each edge's row read from its own
// bucket; kSplit = true adds in the separate/running bucket form,
// kSplit = false adds every edge into the one running sum (one_sum mode).
template <int D, int W, bool kMulti, bool kSplit>
__global__ void __launch_bounds__(kThreads)
segment_sum_tiled(const Buckets bk, const int* __restrict__ perm,
                  const int* __restrict__ offsets,
                  const int4* __restrict__ tiles,
                  const float* __restrict__ var_costs,
                  float* __restrict__ sums, float* __restrict__ beliefs,
                  int chunk) {
  using VT = typename Vec<W>::T;
  constexpr int kVecs = D / W;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_msg = reinterpret_cast<float*>(smem);             // [chunk, D]
  uint8_t* s_bkt = reinterpret_cast<uint8_t*>(s_msg + chunk * D);
  __shared__ const float* s_base[kMaxBuckets];
  __shared__ int s_start[kMaxBuckets + 1];

  const int4 tile = __ldcs(tiles + blockIdx.x);
  const int t = threadIdx.x;
  const int out = tile.x * D + t;
  const bool active = t < (tile.y - tile.x) * D;
  const int k = t % D;
  int lo = 0, hi = 0;
  float cost = 0.0f;
  if (active) {
    lo = __ldcs(offsets + tile.x + t / D);
    hi = __ldcs(offsets + tile.x + t / D + 1);
    cost = __ldcs(var_costs + out);
  }
  if (kMulti) {
    if (t < bk.n) s_base[t] = bk.base[t];
    if (t <= bk.n) s_start[t] = bk.start[t];
    __syncthreads();
  }
  float acc = 0.0f;   // the running sum
  float part = 0.0f;  // the current separate bucket's own sum
  int b = 0;          // bucket of the last edge added
  for (int c = tile.z; c < tile.w; c += chunk) {
    const int n = min(chunk, tile.w - c);
    if (c != tile.z) __syncthreads();  // the last pass's adds are done
    for (int i0 = t; i0 < n; i0 += kUnroll * kThreads) {
      int p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        p[u] = i < n ? __ldcs(perm + c + i) : -1;
      }
      VT row[kUnroll][kVecs];
      int rb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p[u] < 0) continue;
        const float* src;
        if (kMulti) {
          int q = 0;
          while (p[u] >= s_start[q + 1]) ++q;
          rb[u] = q;
          src = s_base[q] + (p[u] - s_start[q]) * D;
        } else {
          src = bk.base[0] + p[u] * D;
        }
        const VT* vsrc = reinterpret_cast<const VT*>(src);
#pragma unroll
        for (int j = 0; j < kVecs; ++j) row[u][j] = __ldg(vsrc + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= n) continue;
        VT* dst = reinterpret_cast<VT*>(s_msg + i * D);
#pragma unroll
        for (int j = 0; j < kVecs; ++j) dst[j] = row[u][j];
        if (kSplit) s_bkt[i] = static_cast<uint8_t>(rb[u]);
      }
    }
    __syncthreads();
    if (active) {
      add_edges<D, kSplit>(s_msg + k, s_bkt, max(lo, c) - c,
                           min(hi, c + n) - c, acc, part, b, bk.sep);
    }
  }
  if (!active) return;
  if (kSplit) leave_buckets(b, bk.n, acc, part, bk.sep);
  __stcs(sums + out, acc);
  __stcs(beliefs + out, fadd_ftz(cost, acc));
}

// D > kMaxTiledD: one thread per (variable, d), walking its edges.
template <bool kMulti, bool kSplit>
__global__ void segment_sum_generic(const Buckets bk,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ offsets,
                                    const float* __restrict__ var_costs,
                                    float* __restrict__ sums,
                                    float* __restrict__ beliefs,
                                    int n_out, int d) {
  __shared__ const float* s_base[kMaxBuckets];
  __shared__ int s_start[kMaxBuckets + 1];
  if (kMulti) {
    if (threadIdx.x < bk.n) s_base[threadIdx.x] = bk.base[threadIdx.x];
    if (threadIdx.x <= bk.n) s_start[threadIdx.x] = bk.start[threadIdx.x];
    __syncthreads();
  }
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int v = t / d;
  const int k = t - v * d;
  const int end = offsets[v + 1];
  float acc = 0.0f;
  float part = 0.0f;
  int b = 0;
  for (int e = offsets[v]; e < end; ++e) {
    const int p = perm[e];
    if (!kMulti) {
      acc = fadd_ftz(acc, bk.base[0][p * d + k]);
      continue;
    }
    int q = kSplit ? b : 0;
    while (p >= s_start[q + 1]) ++q;
    if (!kSplit) {
      acc = fadd_ftz(acc, s_base[q][(p - s_start[q]) * d + k]);
      continue;
    }
    leave_buckets(b, q, acc, part, bk.sep);
    const float m = s_base[b][(p - s_start[b]) * d + k];
    if (separate(bk.sep, b)) {
      part = fadd_ftz(part, m);
    } else {
      acc = fadd_ftz(acc, m);
    }
  }
  if (kSplit) leave_buckets(b, bk.n, acc, part, bk.sep);
  sums[t] = acc;
  beliefs[t] = fadd_ftz(var_costs[t], acc);
}

struct Args {
  Buckets bk;
  const int* perm;
  const int* offsets;
  const int4* tiles;
  int n_tiles;
  const float* var_costs;
  float* sums;
  float* beliefs;
  int chunk;
  int one_sum;
  cudaStream_t stream;
};

template <int D, int W, bool kMulti, bool kSplit>
void launch_tiled(const Args& a) {
  const size_t smem = static_cast<size_t>(a.chunk) *
                      (D * sizeof(float) + (kSplit ? 1 : 0));
  segment_sum_tiled<D, W, kMulti, kSplit>
      <<<a.n_tiles, kThreads, smem, a.stream>>>(
          a.bk, a.perm, a.offsets, a.tiles, a.var_costs, a.sums, a.beliefs,
          a.chunk);
}

template <int D, bool kMulti, bool kSplit>
int launch_width(const Args& a, int w) {
  if constexpr (D % 4 == 0) {
    if (w == 4) {
      launch_tiled<D, 4, kMulti, kSplit>(a);
      return 0;
    }
  }
  if constexpr (D % 2 == 0) {
    if (w == 2) {
      launch_tiled<D, 2, kMulti, kSplit>(a);
      return 0;
    }
  }
  if (w != 1) return static_cast<int>(cudaErrorInvalidValue);
  launch_tiled<D, 1, kMulti, kSplit>(a);
  return 0;
}

template <int D>
int launch_d(const Args& a, int w) {
  if (a.bk.n == 1) return launch_width<D, false, false>(a, w);
  if (a.one_sum) {
    // Rows of one float per load only: fewer instantiations to build,
    // and D = 3 (the common width) loads floats anyway.
    launch_tiled<D, 1, true, false>(a);
    return 0;
  }
  return launch_width<D, true, true>(a, w);
}


// ---------------------------------------------------------------------
// The positional sum: the local search's candidate costs, init plus, per
// variable, the contributions of every (bucket, position) unit of its
// edges.  Replaces pydcop_tpu/ops/localsearch.py:57 positional_sum as
// :103 candidate_costs calls it (init + one segment_sum per unit of the
// fixed cost tables; jnp ops, not a Pallas kernel, made a hand kernel
// for the belief sum's reason: index_add_ adds in no fixed order).
//
// The order: a variable's edges are pos_perm[offsets[v]] ..
// pos_perm[offsets[v + 1] - 1], unit by unit in the placement's unit
// order (ops/segment_sum.py positional_fold: the order XLA adds the
// reference's units in, one-edge units moved where XLA moves them), and
// factor by factor within a unit.  The running sum starts at init; a unit
// whose bit is set in `sep` is summed from +0.0 on its own and then added
// (to every variable, +0.0 where it has no edge there), any other unit is
// added into the running sum edge by edge.  Every add is one fadd_ftz.
// The placement fixes the order, so this kernel knows nothing of XLA.
//
// The read.  Unit u's row for its edge of factor f starts at
//   base[u] + f * row[u] + value * val[u],  entry k at + k * col[u],
// so one formula reads both kinds of unit:
//   - a contributions tensor [F, D] (arity >= 3 after the caller fixed
//     the other axes, arity 1's own costs, the contributions entry):
//     row = D, val = 0, col = 1;
//   - a binary bucket's cost table [F, D, D] read where it lies (the
//     fused entry): position 0 takes column values[other] of the
//     factor's table (row = D*D, val = 1, col = D: D floats at a stride
//     of D), position 1 takes row values[other] (val = D, col = 1: D
//     contiguous floats).  `other` [E] int32 is, per pos_perm slot, the
//     other variable of the binary factor, placed once (device.py), so
//     it is read coalesced beside pos_perm instead of var_ids[f, 1 - p]
//     at random.  `values` [V+1] int32 (4 MB at 1M variables) stays in
//     L2.  These are the loads _fix_other_axes makes, so no arithmetic
//     changes and the bits are the contributions entry's.
//
// Bound: memory.  The fused entry at the scale graph (1M variables, 1.5M
// binary factors, D = 3) must read the tables (54 MB), other and
// pos_perm (12 MB each), values (4 MB), offsets (4 MB), init (12 MB) and
// write the sums (12 MB): ~110 MB, ~0.033 ms at 3.35 TB/s.  The table
// rows are random 12-byte reads (1-2 sectors each), which is what sets
// its pace, as the message rows set the belief sum's.
//
// Design: the belief kernel's tiles and passes (a tile of variables per
// block, each pass's rows gathered into shared memory in CSR order with
// all loads in flight, then added by thread (v, k) in order), with the
// row found by the formula above.  Two units at most (a graph of one
// binary bucket: the flagship and the scale graph) take the few-units
// path: the unit is a select on pos_perm's value, and the split between
// the running and the separate sum is a per-variable boundary placed
// once (`mid`, the first slot of the second unit): the adds run
// [lo, mid) into the running sum and [mid, hi) into the separate one,
// two loops with no per-edge bucket search, bucket byte or branch.
// More units take the belief kernel's multi-bucket path (a search per
// edge, a unit byte in shared memory).  Rows are loaded a float at a
// time: a table row is 4-byte aligned only.  cp.async would copy the
// rows into shared memory without registers, but every address waits on
// the values[other] load, so it would only save registers; not used.
// D > 8: one thread per (variable, k) walking its edges, the same read.

struct Units {
  const float* base[kMaxBuckets];
  int start[kMaxBuckets + 1];
  int row[kMaxBuckets];
  int val[kMaxBuckets];
  int col[kMaxBuckets];
  int n;
  unsigned long long sep;
};

struct UnitRead {
  const float* src;
  int col;
};

// The row of unit q for positional edge p, given the other variable's
// value `value` (0 without tables).
__device__ __forceinline__ UnitRead unit_read(const float* base, int start,
                                              int row, int val, int col,
                                              int p, int value) {
  return {base + static_cast<long long>(p - start) * row + value * val, col};
}

// Edges a thread gathers per round, and blocks an SM holds (40 registers
// a thread at D = 3, no spills).  On the H100 at the scale graph this ran
// faster than 4 edges with 64 or 48 registers (4 or 5 blocks); 4 edges
// with 6 blocks spill.
constexpr int kPosUnroll = 2;
constexpr int kPosMinBlocks = 6;

template <int D, bool kMulti, bool kTable>
__global__ void __launch_bounds__(kThreads, kPosMinBlocks)
positional_tiled(const Units un, const int* __restrict__ values,
                 const int* __restrict__ other, const int* __restrict__ perm,
                 const int* __restrict__ offsets,
                 const int* __restrict__ mid, const int4* __restrict__ tiles,
                 const float* __restrict__ init, float* __restrict__ sums,
                 int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_row = reinterpret_cast<float*>(smem);              // [chunk, D]
  uint8_t* s_unit = reinterpret_cast<uint8_t*>(s_row + chunk * D);
  __shared__ const float* s_base[kMaxBuckets];
  __shared__ int s_start[kMaxBuckets + 1];
  __shared__ int s_rs[kMaxBuckets], s_vs[kMaxBuckets], s_cs[kMaxBuckets];

  const int4 tile = __ldcs(tiles + blockIdx.x);
  const int t = threadIdx.x;
  const int v = tile.x + t / D;
  const int out = tile.x * D + t;
  const bool active = t < (tile.y - tile.x) * D;
  const int k = t % D;
  int lo = 0, hi = 0, split = 0;
  float acc = 0.0f;   // the running sum, from init
  if (active) {
    lo = __ldcs(offsets + v);
    hi = __ldcs(offsets + v + 1);
    acc = __ldcs(init + out);
    if (!kMulti) split = mid != nullptr ? __ldcs(mid + v) : hi;
  }
  if (kMulti) {
    if (t < un.n) {
      s_base[t] = un.base[t];
      s_rs[t] = un.row[t];
      s_vs[t] = un.val[t];
      s_cs[t] = un.col[t];
    }
    if (t <= un.n) s_start[t] = un.start[t];
    __syncthreads();
  }
  float part = 0.0f;  // the separate unit's own sum
  int b = 0;          // unit of the last edge added (kMulti)
  for (int c = tile.z; c < tile.w; c += chunk) {
    const int n = min(chunk, tile.w - c);
    if (c != tile.z) __syncthreads();  // the last pass's adds are done
    for (int i0 = t; i0 < n; i0 += kPosUnroll * kThreads) {
      int p[kPosUnroll];
      int value[kPosUnroll];
#pragma unroll
      for (int u = 0; u < kPosUnroll; ++u) {
        const int i = i0 + u * kThreads;
        p[u] = i < n ? __ldcs(perm + c + i) : -1;
        value[u] = (kTable && i < n) ? __ldcs(other + c + i) : 0;
      }
      if (kTable) {
#pragma unroll
        for (int u = 0; u < kPosUnroll; ++u) {
          if (p[u] >= 0) value[u] = __ldg(values + value[u]);
        }
      }
      float row[kPosUnroll][D];
      int rb[kPosUnroll];
#pragma unroll
      for (int u = 0; u < kPosUnroll; ++u) {
        if (p[u] < 0) continue;
        UnitRead r;
        if (kMulti) {
          int q = 0;
          while (p[u] >= s_start[q + 1]) ++q;
          rb[u] = q;
          r = unit_read(s_base[q], s_start[q], s_rs[q], s_vs[q], s_cs[q],
                        p[u], value[u]);
        } else {
          const bool second = p[u] >= un.start[1];
          r = unit_read(second ? un.base[1] : un.base[0],
                        second ? un.start[1] : 0,
                        second ? un.row[1] : un.row[0],
                        second ? un.val[1] : un.val[0],
                        second ? un.col[1] : un.col[0], p[u], value[u]);
        }
#pragma unroll
        for (int j = 0; j < D; ++j) row[u][j] = __ldg(r.src + j * r.col);
      }
#pragma unroll
      for (int u = 0; u < kPosUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= n) continue;
#pragma unroll
        for (int j = 0; j < D; ++j) s_row[i * D + j] = row[u][j];
        if (kMulti) s_unit[i] = static_cast<uint8_t>(rb[u]);
      }
    }
    __syncthreads();
    if (!active) continue;
    if (kMulti) {
      add_edges<D, true>(s_row + k, s_unit, max(lo, c) - c,
                         min(hi, c + n) - c, acc, part, b, un.sep);
    } else {
      const float* m = s_row + k;
      const int a_end = min(split, c + n) - c;
      for (int e = max(lo, c) - c; e < a_end; ++e) {
        acc = fadd_ftz(acc, m[e * D]);
      }
      const int p_end = min(hi, c + n) - c;
      for (int e = max(split, c) - c; e < p_end; ++e) {
        part = fadd_ftz(part, m[e * D]);
      }
    }
  }
  if (!active) return;
  if (kMulti) {
    leave_buckets(b, un.n, acc, part, un.sep);
  } else if (mid != nullptr) {
    acc = fadd_ftz(acc, part);
  }
  __stcs(sums + out, acc);
}

// D > kMaxTiledD: one thread per (variable, k), walking its edges.
template <bool kTable>
__global__ void positional_generic(const Units un,
                                   const int* __restrict__ values,
                                   const int* __restrict__ other,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ offsets,
                                   const float* __restrict__ init,
                                   float* __restrict__ sums, int n_out,
                                   int d) {
  __shared__ int s_start[kMaxBuckets + 1];
  if (threadIdx.x <= un.n) s_start[threadIdx.x] = un.start[threadIdx.x];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int v = t / d;
  const int k = t - v * d;
  const int end = offsets[v + 1];
  float acc = init[t];
  float part = 0.0f;
  int b = 0;
  for (int e = offsets[v]; e < end; ++e) {
    const int p = perm[e];
    int q = b;
    while (p >= s_start[q + 1]) ++q;
    leave_buckets(b, q, acc, part, un.sep);
    const int value = kTable ? values[other[e]] : 0;
    const UnitRead r = unit_read(un.base[q], s_start[q], un.row[q],
                                 un.val[q], un.col[q], p, value);
    const float m = r.src[k * r.col];
    if (separate(un.sep, b)) {
      part = fadd_ftz(part, m);
    } else {
      acc = fadd_ftz(acc, m);
    }
  }
  leave_buckets(b, un.n, acc, part, un.sep);
  sums[t] = acc;
}

template <int D, bool kMulti, bool kTable>
void launch_positional(const Units& un, const int* values, const int* other,
                       const int* perm, const int* offsets, const int* mid,
                       const int* tiles, int n_tiles, const float* init,
                       float* sums, int chunk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) *
                      (D * sizeof(float) + (kMulti ? 1 : 0));
  positional_tiled<D, kMulti, kTable><<<n_tiles, kThreads, smem, stream>>>(
      un, values, other, perm, offsets, mid,
      reinterpret_cast<const int4*>(tiles), init, sums, chunk);
}

template <int D>
void launch_positional_d(const Units& un, const int* values,
                         const int* other, const int* perm,
                         const int* offsets, const int* mid,
                         const int* tiles, int n_tiles, const float* init,
                         float* sums, int chunk, cudaStream_t stream) {
  const bool multi = un.n > 2;
  if (other != nullptr && multi) {
    launch_positional<D, true, true>(un, values, other, perm, offsets, mid,
                                     tiles, n_tiles, init, sums, chunk,
                                     stream);
  } else if (other != nullptr) {
    launch_positional<D, false, true>(un, values, other, perm, offsets, mid,
                                      tiles, n_tiles, init, sums, chunk,
                                      stream);
  } else if (multi) {
    launch_positional<D, true, false>(un, values, other, perm, offsets, mid,
                                      tiles, n_tiles, init, sums, chunk,
                                      stream);
  } else {
    launch_positional<D, false, false>(un, values, other, perm, offsets,
                                       mid, tiles, n_tiles, init, sums,
                                       chunk, stream);
  }
}

}  // namespace

// bases/starts: host arrays of n_buckets pointers and n_buckets + 1
// edge starts.  w: floats per load (1, 2 or 4; D and every base must
// allow it).  chunk: edges per shared-memory pass.  one_sum: 1 adds
// every bucket's edges into the one running sum (sorted), 0 in the
// separate/running form of `sep` (scatter).  Returns a cudaError_t (0
// when the launch was taken).
extern "C" int segment_sum_launch(const float* const* bases,
                                  const int* starts, int n_buckets,
                                  const int* perm, const int* offsets,
                                  const int* tiles, int n_tiles,
                                  const float* var_costs, float* sums,
                                  float* beliefs, int n_segments, int d,
                                  int w, int chunk, int one_sum,
                                  unsigned long long sep,
                                  cudaStream_t stream) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets || d < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_segments == 0) return 0;
  Args a{};
  for (int b = 0; b < n_buckets; ++b) a.bk.base[b] = bases[b];
  for (int b = 0; b <= n_buckets; ++b) a.bk.start[b] = starts[b];
  a.bk.n = n_buckets;
  a.bk.sep = sep;
  a.perm = perm;
  a.offsets = offsets;
  a.tiles = reinterpret_cast<const int4*>(tiles);
  a.n_tiles = n_tiles;
  a.var_costs = var_costs;
  a.sums = sums;
  a.beliefs = beliefs;
  a.chunk = chunk;
  a.one_sum = one_sum;
  a.stream = stream;
  int err = 0;
  if (d > kMaxTiledD) {
    const int n_out = n_segments * d;
    const int blocks = (n_out + kThreads - 1) / kThreads;
    if (n_buckets == 1) {
      segment_sum_generic<false, false><<<blocks, kThreads, 0, stream>>>(
          a.bk, perm, offsets, var_costs, sums, beliefs, n_out, d);
    } else if (one_sum) {
      segment_sum_generic<true, false><<<blocks, kThreads, 0, stream>>>(
          a.bk, perm, offsets, var_costs, sums, beliefs, n_out, d);
    } else {
      segment_sum_generic<true, true><<<blocks, kThreads, 0, stream>>>(
          a.bk, perm, offsets, var_costs, sums, beliefs, n_out, d);
    }
  } else if (n_tiles > 0) {
    switch (d) {
      case 1: err = launch_d<1>(a, w); break;
      case 2: err = launch_d<2>(a, w); break;
      case 3: err = launch_d<3>(a, w); break;
      case 4: err = launch_d<4>(a, w); break;
      case 5: err = launch_d<5>(a, w); break;
      case 6: err = launch_d<6>(a, w); break;
      case 7: err = launch_d<7>(a, w); break;
      default: err = launch_d<8>(a, w); break;
    }
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The positional sum.  bases/starts/row/val/col: host arrays of n_units
// unit descriptors (the read above) and n_units + 1 positional starts;
// sep: bit i, unit i summed on its own.  values [V+1] and other [E]
// int32 with table units (other == null: contributions only).  mid
// [V+1] int32: with two units whose second is separate, where each
// variable's second-unit edges start (null otherwise).  tiles: the
// belief sum's plan; chunk: edges per shared-memory pass.  Returns a
// cudaError_t (0 when the launch was taken).
extern "C" int positional_sum_launch(
    const float* const* bases, const int* starts, const int* row,
    const int* val, const int* col, int n_units, unsigned long long sep,
    const int* values, const int* other, const int* perm,
    const int* offsets, const int* mid, const int* tiles, int n_tiles,
    const float* init, float* sums, int n_segments, int d, int chunk,
    cudaStream_t stream) {
  if (n_units < 1 || n_units > kMaxBuckets || d < 1 || chunk < 1 ||
      (sep & 1ull) || (mid != nullptr && !(n_units == 2 && (sep & 2ull))) ||
      (other != nullptr && values == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_segments == 0) return 0;
  Units un{};
  for (int u = 0; u < n_units; ++u) {
    un.base[u] = bases[u];
    un.row[u] = row[u];
    un.val[u] = val[u];
    un.col[u] = col[u];
  }
  // One unit: start[1] is E, so the few-units path never picks unit 1.
  for (int u = 0; u <= n_units; ++u) un.start[u] = starts[u];
  un.n = n_units;
  un.sep = sep;
  if (d > kMaxTiledD) {
    const int n_out = n_segments * d;
    const int blocks = (n_out + kThreads - 1) / kThreads;
    if (other != nullptr) {
      positional_generic<true><<<blocks, kThreads, 0, stream>>>(
          un, values, other, perm, offsets, init, sums, n_out, d);
    } else {
      positional_generic<false><<<blocks, kThreads, 0, stream>>>(
          un, values, other, perm, offsets, init, sums, n_out, d);
    }
  } else if (n_tiles > 0) {
    switch (d) {
#define POSITIONAL_D(N)                                                     \
  case N:                                                                   \
    launch_positional_d<N>(un, values, other, perm, offsets, mid, tiles,    \
                           n_tiles, init, sums, chunk, stream);             \
    break;
      POSITIONAL_D(1)
      POSITIONAL_D(2)
      POSITIONAL_D(3)
      POSITIONAL_D(4)
      POSITIONAL_D(5)
      POSITIONAL_D(6)
      POSITIONAL_D(7)
      default:
        launch_positional_d<8>(un, values, other, perm, offsets, mid, tiles,
                               n_tiles, init, sums, chunk, stream);
        break;
#undef POSITIONAL_D
    }
  }
  return static_cast<int>(cudaGetLastError());
}
