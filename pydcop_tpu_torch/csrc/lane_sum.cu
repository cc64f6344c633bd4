// The lane layout's belief sum: per variable and domain slot, the sum of
// its incoming factor->variable messages in a FIXED order, and the
// beliefs, as one row table [V+1, 2P] (row v: beliefs[v, 0..D), then
// sums[v, 0..D), each padded to P floats) that the variable side
// gathers one row an edge.
//
// Replaces pydcop_tpu/ops/maxsum_lane.py:318 (aggregate_beliefs): per
// bucket `sums.at[:, seg].add(flat)` over the messages [D, a, F] as
// [D, a*F], the buckets' scatters chained from zeros, then
// var_costs + sums.  That is jnp code, not a Pallas kernel; it is a hand
// kernel because the card's index_add_ adds with atomics in no fixed
// order, so the sums' last bits, and with them the whole trajectory,
// would change from run to run and differ from the reference.
//
// The order is part of the contract.  XLA:CPU runs each scatter as one
// serial loop over its updates, so a variable's sum is one running sum
// from +0.0f over its edges in the global position-major order: bucket
// after bucket, within a bucket position after position, within a
// position factor after factor.  Each add is add.rn.ftz.f32 (a subnormal
// result flushed to zero, as XLA:CPU flushes the reference's), so the
// sums equal the plain version (ops/lane_sum.py lane_sum_reference)
// and the jitted reference bit for bit.  No tree or shuffle reduction
// and no atomics touch a sum.  Mode `from_costs` is the same walk from
// var_costs[:, v] instead of +0.0f, writing only the beliefs ([V+1, P]):
// where the reference keeps no sums (the values selected after a run or
// a traced cycle) XLA scatters the messages into var_costs directly.
//
// Layout: messages [D, a, F] float32 per bucket (bases and edge starts
// by value in the parameters), perm [E] int32, offsets [V+2] int32,
// heavy [n_heavy] int32, var_costs [D, V+1] float32; rows [E, D]
// float32 scratch; out [V+1, 2P] float32 (beliefs, then sums, each
// padded with zeros to P floats: one aligned 32- or 64-byte row at
// D <= 8 that the variable side's kernel reads with 16-byte loads), or
// [V+1, P] from costs.  P is the caller's (ops/lane_sum.py row_floats
// owns the format): at least D, and a multiple of 4 up to D = 8.
// ops/lane_sum.py lane_order and heavy_variables build perm, offsets and
// heavy once, at placement.
//
// Bound: memory.  Per call it must read E*D*4 (messages) + E*4 (perm)
// + (V+2)*4 (offsets) + (V+1)*D*4 (var_costs) bytes and write
// 2*(V+1)*D*4: 88 MB at the 1M-variable scale graph (D = 3, 3M edges),
// 0.0263 ms at 3.35 TB/s.
//
// The sector problem.  The messages are lane-major: edge e's D slots lie
// in D rows of [D, a*F], so a walk in a variable's order pays one
// 32-byte sector for each 4-byte slot (~288 MB at scale; the first
// design, one thread per (slot, variable), took 0.101 ms).  Here:
// 1. lane_rows: one thread an edge, in edge order, reads the edge's D
//    slots (row k: consecutive threads on consecutive edges, coalesced)
//    and writes them as row e of `rows` [E, D] (coalesced too).  A
//    block finds its bucket once, from the block starts in the
//    parameters; no edge scans the bucket starts.
// 2. lane_walk: each variable's edges are perm[offsets[v]] ..
//    perm[offsets[v + 1] - 1]; an edge is one D-float row (one or two
//    sectors, ~1.25 at D = 3), not D sectors.  A light variable
//    (degree <= heavy_degree) is one thread, D running sums in
//    registers (D = 1..8 templated), which issues the perm entries and
//    rows of four edges before it adds them; a heavy one (the
//    scale-free graph's hubs reach degree 1,517) is one warp of its
//    own, placed first: the warp loads 32 rows at once (the next 32 in
//    flight while it adds) and every lane adds them in order from
//    shuffles, so the chain stays one running sum.  Above D = 8 one
//    thread takes one (variable, slot).
// What bounds it (measured on an H100 80GB HBM3): the walk's random
// 12-byte row reads, ~0.076-0.079 ms at scale however they are issued
// (a thread a variable or a thread a (variable, slot), four or eight
// edges in flight), as the edge layout's segment_sum.cu is bounded by
// the same reads.  Rows padded to 16 bytes walked slower (0.089 ms),
// rows scattered to their walk positions cost 0.18 ms to write, and
// reading the lane-major slots straight through the permutation
// 0.135-0.14 ms; L2 hints made it slower (the rows stored evict-last
// and the streams read evict-first 0.128 ms; the streams alone
// 0.107-0.118).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float fadd_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Buckets {
  const float* base[kMaxBuckets];
  int start[kMaxBuckets + 1];  // first edge of bucket b; start[n] = E
  int block[kMaxBuckets + 1];  // first lane_rows block of bucket b
  int n;
};

// p floats of `r` (the slots, then zeros) as 16-byte stores; p is a
// multiple of 4 of at least D.
template <int D>
__device__ __forceinline__ void store_row(float* dst, const float* r, int p) {
  constexpr int kSlots = (D + 3) / 4 * 4;
#pragma unroll
  for (int k = 0; k < kSlots; k += 4)
    *reinterpret_cast<float4*>(dst + k) =
        make_float4(k < D ? r[k] : 0.0f, k + 1 < D ? r[k + 1] : 0.0f,
                    k + 2 < D ? r[k + 2] : 0.0f, k + 3 < D ? r[k + 3] : 0.0f);
  for (int k = kSlots; k < p; k += 4)
    *reinterpret_cast<float4*>(dst + k) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Row stage: edge e's D slots (row k of its bucket's [D, a*F], read
// coalesced) as row e of `rows` [E, D].  D = 0: the runtime d.
template <int D>
__global__ void __launch_bounds__(kThreads)
    lane_rows(const Buckets bk, float* __restrict__ rows, int d) {
  int b = 0;
  while (b + 1 < bk.n && static_cast<int>(blockIdx.x) >= bk.block[b + 1]) ++b;
  const int n_b = bk.start[b + 1] - bk.start[b];
  const int i = (static_cast<int>(blockIdx.x) - bk.block[b]) * kThreads
                + threadIdx.x;
  if (i >= n_b) return;
  const int64_t e = bk.start[b] + i;
  const float* src = bk.base[b] + i;
  const int dd = D > 0 ? D : d;
  for (int k = 0; k < dd; ++k)
    rows[e * dd + k] = __ldg(src + static_cast<int64_t>(k) * n_b);
}

struct Walk {
  const float* rows;
  const int* perm;
  const int* offsets;
  const int* heavy;
  const float* var_costs;
  float* out;
  int n_heavy;
  int heavy_blocks;
  int heavy_degree;
  int n_rows;
  int p;  // floats in each half of a table row
  int from_costs;
};

// The D slots of the edge at walk position i: its row, through perm.
template <int D>
__device__ __forceinline__ void fetch(const Walk& w, int i, float* x) {
  const float* r = w.rows + static_cast<int64_t>(__ldg(w.perm + i)) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) x[k] = __ldg(r + k);
}

template <int D>
__device__ __forceinline__ void start_sums(const Walk& w, int v, float* acc) {
#pragma unroll
  for (int k = 0; k < D; ++k)
    acc[k] = w.from_costs
                 ? __ldg(w.var_costs + static_cast<int64_t>(k) * w.n_rows + v)
                 : 0.0f;
}

// The table row of v: beliefs, then sums, each padded to P floats (or,
// from costs, the beliefs alone).
template <int D>
__device__ __forceinline__ void put_row(const Walk& w, int v,
                                        const float* acc) {
  if (w.from_costs) {
    store_row<D>(w.out + static_cast<int64_t>(v) * w.p, acc, w.p);
    return;
  }
  float bel[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    bel[k] = fadd_ftz(
        __ldg(w.var_costs + static_cast<int64_t>(k) * w.n_rows + v), acc[k]);
  float* row = w.out + static_cast<int64_t>(v) * 2 * w.p;
  store_row<D>(row, bel, w.p);
  store_row<D>(row + w.p, acc, w.p);
}

template <int D>
__global__ void __launch_bounds__(kThreads) lane_walk(const Walk w) {
  if (static_cast<int>(blockIdx.x) < w.heavy_blocks) {
    const int h = blockIdx.x * kWarps + threadIdx.x / 32;
    if (h >= w.n_heavy) return;  // warp-uniform
    const int lane = threadIdx.x & 31;
    const int v = __ldg(w.heavy + h);
    const int lo = __ldg(w.offsets + v);
    const int hi = __ldg(w.offsets + v + 1);
    float acc[D], cur[D], nxt[D];
    start_sums<D>(w, v, acc);
    if (lo + lane < hi) fetch<D>(w, lo + lane, cur);
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      const int ahead = base + 32 + lane;
      if (ahead < hi) fetch<D>(w, ahead, nxt);
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int k = 0; k < D; ++k)
          acc[k] = fadd_ftz(acc[k], __shfl_sync(0xffffffffu, cur[k], j));
      }
#pragma unroll
      for (int k = 0; k < D; ++k) cur[k] = nxt[k];
    }
    if (lane == 0) put_row<D>(w, v, acc);
    return;
  }
  const int v = (static_cast<int>(blockIdx.x) - w.heavy_blocks) * kThreads
                + threadIdx.x;
  if (v >= w.n_rows) return;
  const int lo = __ldg(w.offsets + v);
  const int hi = __ldg(w.offsets + v + 1);
  if (hi - lo > w.heavy_degree) return;  // its warp writes it
  float acc[D];
  start_sums<D>(w, v, acc);
  // kUnroll edges at a time: their perm entries, then their rows, all
  // in flight before the adds (in order).
  for (int i = lo; i < hi; i += kUnroll) {
    float x[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u < hi) fetch<D>(w, i + u, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u < hi) {
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = fadd_ftz(acc[k], x[u][k]);
      }
  }
  put_row<D>(w, v, acc);
}

// Above D = 8: one thread per (variable, slot), slot fastest; rows
// unpadded, the thread of slot k also writing the pads d + k, 2d + k,
// ... below P of its table row.
__global__ void __launch_bounds__(kThreads)
    lane_walk_generic(const Walk w, int d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(w.n_rows) * d) return;
  const int v = static_cast<int>(t / d);
  const int k = static_cast<int>(t % d);
  const int lo = __ldg(w.offsets + v);
  const int hi = __ldg(w.offsets + v + 1);
  const float cost =
      __ldg(w.var_costs + static_cast<int64_t>(k) * w.n_rows + v);
  float acc = w.from_costs ? cost : 0.0f;
  for (int i = lo; i < hi; ++i) {
    const int64_t row = __ldg(w.perm + i);
    acc = fadd_ftz(acc, __ldg(w.rows + row * d + k));
  }
  float* row = w.out + static_cast<int64_t>(v) * (w.from_costs ? 1 : 2) * w.p;
  if (w.from_costs) {
    row[k] = acc;
  } else {
    row[k] = fadd_ftz(cost, acc);
    row[w.p + k] = acc;
  }
  for (int j = d + k; j < w.p; j += d) {
    row[j] = 0.0f;
    if (!w.from_costs) row[w.p + j] = 0.0f;
  }
}

template <int D>
void launch_walk(const Walk& w, cudaStream_t stream) {
  const int light = (w.n_rows + kThreads - 1) / kThreads;
  lane_walk<D><<<w.heavy_blocks + light, kThreads, 0, stream>>>(w);
}

template <int D>
void launch_rows(const Buckets& bk, int blocks, float* rows, int d,
                 cudaStream_t stream) {
  lane_rows<D><<<blocks, kThreads, 0, stream>>>(bk, rows, d);
}

}  // namespace

extern "C" int lane_sum_launch(const float* const* bases, const int* starts,
                               int n_buckets, const int* perm,
                               const int* offsets, const int* heavy,
                               int n_heavy, int heavy_degree,
                               const float* var_costs, float* rows,
                               float* out, int n_rows, int d, int p,
                               int from_costs, cudaStream_t stream) {
  if (n_buckets > kMaxBuckets || d < 1 || p < d || (d <= 8 && p % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Buckets bk;
  bk.n = n_buckets;
  int blocks = 0;
  for (int b = 0; b < n_buckets; ++b) {
    bk.base[b] = bases[b];
    bk.start[b] = starts[b];
    bk.block[b] = blocks;
    blocks += (starts[b + 1] - starts[b] + kThreads - 1) / kThreads;
  }
  bk.start[n_buckets] = starts[n_buckets];
  bk.block[n_buckets] = blocks;
  if (blocks > 0) {
    switch (d) {
      case 1: launch_rows<1>(bk, blocks, rows, d, stream); break;
      case 2: launch_rows<2>(bk, blocks, rows, d, stream); break;
      case 3: launch_rows<3>(bk, blocks, rows, d, stream); break;
      case 4: launch_rows<4>(bk, blocks, rows, d, stream); break;
      case 5: launch_rows<5>(bk, blocks, rows, d, stream); break;
      case 6: launch_rows<6>(bk, blocks, rows, d, stream); break;
      case 7: launch_rows<7>(bk, blocks, rows, d, stream); break;
      case 8: launch_rows<8>(bk, blocks, rows, d, stream); break;
      default: launch_rows<0>(bk, blocks, rows, d, stream); break;
    }
  }
  Walk w;
  w.rows = rows;
  w.perm = perm;
  w.offsets = offsets;
  w.heavy = heavy;
  w.var_costs = var_costs;
  w.out = out;
  w.n_heavy = d <= 8 ? n_heavy : 0;
  w.heavy_blocks = (w.n_heavy + kWarps - 1) / kWarps;
  w.heavy_degree = d <= 8 && n_heavy > 0 ? heavy_degree : 0x7fffffff;
  w.n_rows = n_rows;
  w.p = p;
  w.from_costs = from_costs;
  switch (d) {
    case 1: launch_walk<1>(w, stream); break;
    case 2: launch_walk<2>(w, stream); break;
    case 3: launch_walk<3>(w, stream); break;
    case 4: launch_walk<4>(w, stream); break;
    case 5: launch_walk<5>(w, stream); break;
    case 6: launch_walk<6>(w, stream); break;
    case 7: launch_walk<7>(w, stream); break;
    case 8: launch_walk<8>(w, stream); break;
    default: {
      const int64_t n = static_cast<int64_t>(n_rows) * d;
      lane_walk_generic<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(w, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
