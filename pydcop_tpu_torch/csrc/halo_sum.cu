// The partitioned engine's cross-shard reduction: the [B, D] halo totals
// from S per-shard [B, D] boundary partials, and the per-shard scalar
// costs of a traced run, summed in the order the reference's all-reduce
// sums them.
//
// Replaces the jax.lax.psum calls of pydcop_tpu/engine/sharding.py:426
// (_exchange_halo: the boundary partials) and :765 (run_maxsum_trace's
// cost_of: one scalar a shard).  They are XLA collectives, not Pallas
// kernels; they became a hand kernel because the sum has an order, and a
// library reduction (torch.sum over the stacked partials, an all-reduce)
// picks its own and keeps subnormals.
//
// The order is part of the contract.  XLA:CPU's all-reduce (jax 0.9.0,
// shard_map over forced host devices; probed over 1, 3 and 6 decades and
// subnormal draws at S = 2..8) starts every element from +0.0f and adds
// the shards' values in mesh (rank) order, each add with subnormal
// operands read as zeros of their sign and a subnormal result flushed.
// Here that is one add.rn.ftz.f32 per shard from +0.0f: the .ftz form
// reads and writes subnormals exactly so.  So the totals equal the plain
// version (ops/halo_sum.py halo_sum_reference) and the reference's bit
// for bit.
//
// Layout: the S partials are S separate [n] float32 buffers (the shards'
// own outputs, read where they lie, or rows of one stacked [S, n]
// tensor); their base pointers travel in the kernel's parameter block.
// One thread takes one element and walks the shards in order.
//
// Bound: memory.  It must read S*n*4 bytes and write n*4; nothing is
// reused, so the loads stream (__ldcs).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;

struct Parts {
  const float* base[kMaxShards];
  int n_shards;
};

__device__ __forceinline__ float fadd_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void halo_sum_kernel(const Parts parts, float* __restrict__ out,
                                long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < parts.n_shards; ++s) {
    acc = fadd_ftz(acc, __ldcs(parts.base[s] + i));
  }
  out[i] = acc;
}

}  // namespace

// bases: host array of n_shards pointers to [n] float32 partials on the
// launch device; out: [n] float32.  Returns a cudaError_t (0 when the
// launch was taken).
extern "C" int halo_sum_launch(const float* const* bases, int n_shards,
                               float* out, long long n,
                               cudaStream_t stream) {
  if (n_shards < 1 || n_shards > kMaxShards || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Parts parts{};
  for (int s = 0; s < n_shards; ++s) parts.base[s] = bases[s];
  parts.n_shards = n_shards;
  const long long blocks = (n + kThreads - 1) / kThreads;
  halo_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      parts, out, n);
  return static_cast<int>(cudaGetLastError());
}
