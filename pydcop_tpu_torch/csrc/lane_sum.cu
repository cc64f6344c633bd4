// The lane layout's belief sum: per variable and domain slot, the sum of
// its incoming factor->variable messages in a FIXED order, and the
// beliefs, both lane-major ([D, V+1]).
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
// and no atomics touch a sum.
//
// A variable's edges in that order are perm[offsets[v]] ..
// perm[offsets[v + 1] - 1] (a stable sort by variable of the edges
// numbered position-major, bucket after bucket, built at placement by
// ops/lane_sum.py lane_order); edge e belongs to bucket b when
// start[b] <= e < start[b + 1], and its message in slot k is
// base[b][k * n_b + (e - start[b])], n_b = start[b + 1] - start[b] (the
// [D, a*F] row length).  The messages are read where they lie.  Bases
// and starts come by value in the kernel's parameters.
//
// Layout: messages [D, a, F] float32 per bucket, perm [E] int32,
// offsets [V+2] int32, var_costs [D, V+1] float32; sums and beliefs
// [D, V+1] float32 out (allocated by the wrapper).
//
// Design (simple): one thread per (slot k, variable v), v fastest, so a
// warp writes 32 consecutive floats of a row of sums and beliefs and
// reads 32 consecutive offsets; it walks its variable's edges, reading
// perm and the message floats (a gather).  The bucket of an edge is
// found by a scan over at most kMaxBuckets starts.
//
// Bound: memory.  Per call it must read E*D*4 (messages) + E*4 (perm)
// + (V+2)*4 (offsets) + (V+1)*D*4 (var_costs) bytes and write
// 2*(V+1)*D*4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float fadd_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Buckets {
  const float* base[kMaxBuckets];
  int start[kMaxBuckets + 1];
  int n;
};

__global__ void __launch_bounds__(kThreads)
    lane_sum_kernel(const Buckets bk, const int* __restrict__ perm,
                    const int* __restrict__ offsets,
                    const float* __restrict__ var_costs,
                    float* __restrict__ sums, float* __restrict__ beliefs,
                    int n_rows, int d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (t >= static_cast<int64_t>(n_rows) * d) return;
  const int v = static_cast<int>(t % n_rows);
  const int k = static_cast<int>(t / n_rows);
  const int lo = __ldg(offsets + v);
  const int hi = __ldg(offsets + v + 1);
  float acc = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const int e = __ldg(perm + i);
    int b = 0;
    while (b + 1 < bk.n && e >= bk.start[b + 1]) ++b;
    const int64_t n_b = bk.start[b + 1] - bk.start[b];
    acc = fadd_ftz(acc, __ldg(bk.base[b] + k * n_b + (e - bk.start[b])));
  }
  sums[t] = acc;
  beliefs[t] = fadd_ftz(__ldg(var_costs + t), acc);
}

}  // namespace

extern "C" int lane_sum_launch(const float* const* bases,
                               const int* starts, int n_buckets,
                               const int* perm, const int* offsets,
                               const float* var_costs, float* sums,
                               float* beliefs, int n_rows, int d,
                               cudaStream_t stream) {
  if (n_buckets > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  Buckets bk;
  bk.n = n_buckets;
  for (int b = 0; b < n_buckets; ++b) bk.base[b] = bases[b];
  for (int b = 0; b <= n_buckets; ++b) bk.start[b] = starts[b];
  const int64_t n = static_cast<int64_t>(n_rows) * d;
  if (n == 0) return 0;
  lane_sum_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, stream>>>(bk, perm, offsets, var_costs,
                                           sums, beliefs, n_rows, d);
  return static_cast<int>(cudaGetLastError());
}
