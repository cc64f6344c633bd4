// jax.random's uniform draws on the card: threefry-2x32 hashed per
// element, bit for bit the reference's numbers.
//
// Replaces the jnp ops `jax.random.uniform(key, shape)` of the local
// search (pydcop_tpu/ops/localsearch.py:316 random_best_choice, :324
// random_initial_values, pydcop_tpu/ops/dsa.py:164, ops/mgm.py:57,
// ops/mgm2.py:127,140,183,204,222).  On the TPU XLA fuses each draw into
// one kernel; torch has no such op (torch.rand is Philox, another
// generator), and the plain version (utils/prng.py) runs some 200 int64
// torch ops a draw.  So the draw is a hand kernel, and its key comes in
// the kernel's arguments from the host key chain, never from the
// device.
//
// The numbers (jax 0.9.0, jax_threefry_partitionable): element i of a
// row-major shape hashes the counter (i >> 32, i & 0xFFFFFFFF) under the
// key (k0, k1) with threefry-2x32, 20 rounds, and XORs the two output
// words.  The top 23 bits become the mantissa of a float in [1, 2);
// minus 1 gives f in [0, 1), and the draw is max(lo, fma(f, span, lo)):
// XLA:CPU contracts the scaling into one fused multiply-add, and so
// does this kernel (`fmaf`).  All integer arithmetic is native uint32
// (wrap-around is the hash's arithmetic); rotations are funnel shifts.
//
// Two entry points:
//   threefry_uniform_launch: out[i] = the draw of element i, i < n.
//   threefry_best_choice_launch: per row r of an [N, K] uint8 mask,
//     argmax_j where(mask[r, j], u[r, j], -1.0) with u the draws of the
//     shape (N, K) (element r * K + j), the first index on ties, 0 for an
//     empty row: jnp.argmax(jnp.where(mask, uniform(key, (N, K)), -1.0),
//     axis=1).  It hashes only the masked elements and writes no draw.
//
// Bound: integer work.  A draw is about 70 32-bit integer operations on
// the INT32 pipe (60 in the rounds, 10 in the key injections less the 5
// adds that merge into three-input adds, 2 initial adds, the final xor,
// the shift and or of the conversion; the float subtract, FMA and max
// run on the FP32 pipe) against a 4-byte store (best_choice: K one-byte
// mask reads and one 4-byte store a row), so at the H100's 64 INT32
// lanes a clock per SM the hash, not memory, bounds both.  One thread takes one element (uniform) or one row
// (best_choice): there is nothing to share between threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// The XOR of threefry-2x32's two output words for counter (c0, c1).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1,
                                      unsigned long long i, float lo,
                                      float span) {
  const uint32_t bits = threefry_bits(k0, k1, static_cast<uint32_t>(i >> 32),
                                      static_cast<uint32_t>(i));
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, __fmaf_rn(f, span, lo));
}

__global__ void __launch_bounds__(kThreads)
uniform_kernel(uint32_t k0, uint32_t k1, long long n, float lo, float span,
               float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = draw(k0, k1, static_cast<unsigned long long>(i), lo, span);
  }
}

__global__ void __launch_bounds__(kThreads)
best_choice_kernel(uint32_t k0, uint32_t k1,
                   const uint8_t* __restrict__ mask, int n_rows, int k,
                   int* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const unsigned long long base = static_cast<unsigned long long>(r) * k;
  float best = -1.0f;
  int arg = 0;
  for (int j = 0; j < k; ++j) {
    if (!mask[base + j]) continue;
    const float u = draw(k0, k1, base + j, 0.0f, 1.0f);
    if (u > best) {
      best = u;
      arg = j;
    }
  }
  out[r] = arg;
}

}  // namespace

// Each returns a cudaError_t (0 when the launch was taken).
extern "C" int threefry_uniform_launch(uint32_t k0, uint32_t k1, long long n,
                                       float lo, float span, float* out,
                                       cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond
  uniform_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      k0, k1, n, lo, span, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_best_choice_launch(uint32_t k0, uint32_t k1,
                                           const uint8_t* mask, int n_rows,
                                           int k, int* out,
                                           cudaStream_t stream) {
  if (n_rows < 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  best_choice_kernel<<<blocks, kThreads, 0, stream>>>(k0, k1, mask, n_rows,
                                                      k, out);
  return static_cast<int>(cudaGetLastError());
}
