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
// the running sum; an odd bucket is summed from +0.0f on its own and
// then added to it; an even bucket (2, 4, ...) is added into it edge by
// edge.  Then beliefs = var_costs + sums.  So the sums equal the CPU's
// index_add_ form (segment_sum_reference) and the reference's jitted
// superstep bit for bit.  A tree reduction or a warp shuffle would
// change the bits, so there is none.
//
// A variable's edges are perm[offsets[v]] .. perm[offsets[v + 1] - 1]
// (a stable sort of the edges by variable, built at placement by
// device.aggregation_arrays); edge p belongs to bucket b when
// buckets[b] <= p < buckets[b + 1].
//
// Layout: messages [E, D] float32 (the buckets' [F, arity, D] messages
// flattened and, for several buckets, concatenated in bucket order),
// perm [E] int32, offsets [V+2] int32, buckets [n_buckets+1] int32,
// var_costs [V+1, D] float32; sums and beliefs [V+1, D] float32 out
// (allocated by the wrapper).  The sentinel row V sums the padding
// edges like any other row.
//
// Bound: memory.  Per call it must read E*D*4 (messages) + E*4 (perm)
// + (V+2)*4 (offsets) + (V+1)*D*4 (var_costs) bytes and write
// 2*(V+1)*D*4: ~0.88 MB for the 10k-variable flagship (launch-bound)
// and ~88 MB for the 1M-variable scale graph (~26 us at 3.35 TB/s).
// The messages are read through the permutation, one 12-byte row per
// edge at D=3, so a random graph reads whole 32-byte sectors and lands
// well above that bound.
//
// Design (simple and right): one thread per (variable, d), 32-bit
// index math (the wrapper refuses E*D or (V+1)*D >= 2^31), adding its
// variable's edges one after the other.  A graph of one bucket takes a
// variant without the bucket bookkeeping (on an H100 the bookkeeping
// slowed the 1M-variable graph from ~74 to ~82 us).  A high-degree hub
// serialises its variable's threads; splitting a hub's edges across
// threads is later work and must keep this order.

#include <cuda_runtime.h>

namespace {

// kMulti = false: one bucket, so every edge adds into the running sum
// (the flagship and the scale graph; no bucket bookkeeping at all).
template <bool kMulti>
__global__ void segment_sum_kernel(const float* __restrict__ msgs,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ buckets,
                                   const float* __restrict__ var_costs,
                                   float* __restrict__ sums,
                                   float* __restrict__ beliefs,
                                   int n_out, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int v = t / d;
  const int k = t - v * d;
  const int end = offsets[v + 1];
  float acc = 0.0f;   // the running sum
  float part = 0.0f;  // the current odd bucket's own sum
  int b = 0;          // bucket of the edge being added
  int next = kMulti ? buckets[1] : 0;
  for (int e = offsets[v]; e < end; ++e) {
    const int p = perm[e];
    const float m = msgs[p * d + k];
    if (!kMulti) {
      acc = __fadd_rn(acc, m);
      continue;
    }
    while (p >= next) {  // leave bucket b (edges come in bucket order)
      if (b & 1) {
        acc = __fadd_rn(acc, part);
        part = 0.0f;
      }
      next = buckets[++b + 1];
    }
    if (b & 1) {
      part = __fadd_rn(part, m);
    } else {
      acc = __fadd_rn(acc, m);
    }
  }
  if (b & 1) acc = __fadd_rn(acc, part);
  sums[t] = acc;
  beliefs[t] = __fadd_rn(var_costs[t], acc);
}

}  // namespace

extern "C" int segment_sum_launch(const float* msgs, const int* perm,
                                  const int* offsets, const int* buckets,
                                  int n_buckets, const float* var_costs,
                                  float* sums, float* beliefs,
                                  int n_segments, int d,
                                  cudaStream_t stream) {
  const int n_out = n_segments * d;
  if (n_out == 0) return 0;  // the wrapper passes n_buckets >= 1
  const int threads = 256;
  const int blocks = (n_out + threads - 1) / threads;
  if (n_buckets > 1) {
    segment_sum_kernel<true><<<blocks, threads, 0, stream>>>(
        msgs, perm, offsets, buckets, var_costs, sums, beliefs, n_out, d);
  } else {
    segment_sum_kernel<false><<<blocks, threads, 0, stream>>>(
        msgs, perm, offsets, buckets, var_costs, sums, beliefs, n_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}
