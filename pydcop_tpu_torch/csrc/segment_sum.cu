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
// The positional mode (init_first = 1) is the local search's
// candidate-cost sum (pydcop_tpu/ops/localsearch.py:57 positional_sum:
// init + one segment_sum per (bucket, position), the same jnp ops made a
// hand kernel for the same reason).  Its "buckets" are the (bucket,
// position) units of the position-major contributions, the running sum
// starts at var_costs (XLA folds the first unit's scatter into `init`),
// the separate/running form is the same fold over the units, and the
// result is written to `sums` alone (no beliefs).
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
// kInit = true is the positional mode: each running sum starts at
// var_costs and only the sums are written (a template parameter, so the
// belief sum's instantiations are the code they were without it).
template <int D, int W, bool kMulti, bool kSplit, bool kInit>
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
  float acc = kInit ? cost : 0.0f;  // the running sum
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
  if (!kInit) __stcs(beliefs + out, fadd_ftz(cost, acc));
}

// D > kMaxTiledD: one thread per (variable, d), walking its edges.
template <bool kMulti, bool kSplit, bool kInit>
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
  float acc = kInit ? var_costs[t] : 0.0f;
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
  if (!kInit) beliefs[t] = fadd_ftz(var_costs[t], acc);
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
  int init_first;
  cudaStream_t stream;
};

template <int D, int W, bool kMulti, bool kSplit, bool kInit = false>
void launch_tiled(const Args& a) {
  const size_t smem = static_cast<size_t>(a.chunk) *
                      (D * sizeof(float) + (kSplit ? 1 : 0));
  segment_sum_tiled<D, W, kMulti, kSplit, kInit>
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
  if (a.init_first) {
    // The positional mode loads rows a float at a time (D = 3, its
    // common width, does anyway) and always folds separate units.
    if (a.bk.n == 1) {
      launch_tiled<D, 1, false, false, true>(a);
    } else {
      launch_tiled<D, 1, true, true, true>(a);
    }
    return 0;
  }
  if (a.bk.n == 1) return launch_width<D, false, false>(a, w);
  if (a.one_sum) {
    // Rows of one float per load only: fewer instantiations to build,
    // and D = 3 (the common width) loads floats anyway.
    launch_tiled<D, 1, true, false>(a);
    return 0;
  }
  return launch_width<D, true, true>(a, w);
}

}  // namespace

// bases/starts: host arrays of n_buckets pointers and n_buckets + 1
// edge starts.  w: floats per load (1, 2 or 4; D and every base must
// allow it).  chunk: edges per shared-memory pass.  one_sum: 1 adds
// every bucket's edges into the one running sum (sorted), 0 in the
// separate/running form of `sep` (scatter).  init_first: 1 starts each
// running sum at var_costs and writes only `sums` (the positional mode;
// beliefs may be null), 0 starts at +0.0 and writes both.  Returns a
// cudaError_t (0 when the launch was taken).
extern "C" int segment_sum_launch(const float* const* bases,
                                  const int* starts, int n_buckets,
                                  const int* perm, const int* offsets,
                                  const int* tiles, int n_tiles,
                                  const float* var_costs, float* sums,
                                  float* beliefs, int n_segments, int d,
                                  int w, int chunk, int one_sum,
                                  unsigned long long sep, int init_first,
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
  a.init_first = init_first;
  a.stream = stream;
  int err = 0;
  if (d > kMaxTiledD) {
    const int n_out = n_segments * d;
    const int blocks = (n_out + kThreads - 1) / kThreads;
    if (init_first && n_buckets == 1) {
      segment_sum_generic<false, false, true>
          <<<blocks, kThreads, 0, stream>>>(a.bk, perm, offsets, var_costs,
                                            sums, beliefs, n_out, d);
    } else if (init_first) {
      segment_sum_generic<true, true, true>
          <<<blocks, kThreads, 0, stream>>>(a.bk, perm, offsets, var_costs,
                                            sums, beliefs, n_out, d);
    } else if (n_buckets == 1) {
      segment_sum_generic<false, false, false>
          <<<blocks, kThreads, 0, stream>>>(a.bk, perm, offsets, var_costs,
                                            sums, beliefs, n_out, d);
    } else if (one_sum) {
      segment_sum_generic<true, false, false>
          <<<blocks, kThreads, 0, stream>>>(a.bk, perm, offsets, var_costs,
                                            sums, beliefs, n_out, d);
    } else {
      segment_sum_generic<true, true, false>
          <<<blocks, kThreads, 0, stream>>>(a.bk, perm, offsets, var_costs,
                                            sums, beliefs, n_out, d);
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
