// Binary-factor MaxSum update: every factor->variable message of one
// arity-2 bucket, as a min-plus reduction over the factor's D x D table.
//
// Replaces the TPU Pallas kernel pydcop_tpu/ops/pallas_maxsum.py:54
// (binary_factor_update, body _kernel at :40).  It computes the same
// function in the ADD ORDER of the reference's dense path
// (pydcop_tpu/ops/maxsum.py factor_to_var), not the Pallas form
// c + m_other:
//
//   t[f,i,j]   = (costs[f,i,j] + v2f[f,0,i]) + v2f[f,1,j]
//   out[f,0,i] = min_j t[f,i,j] - v2f[f,0,i]     (j = 0, 1, ... in order)
//   out[f,1,j] = min_i t[f,i,j] - v2f[f,1,j]     (i = 0, 1, ... in order)
//
// Reassociating these adds drifts MaxSum trajectories within ~15
// cycles even on integer tables (damping and mean-normalisation
// accrete mantissa bits), so the order is part of the contract.  Only
// adds, mins and subtracts, each a PTX instruction with .ftz (a
// subnormal result flushed to zero, as XLA:CPU flushes the reference's):
// there is no multiply for nvcc to contract into an FMA, and the result
// equals the plain torch version (which flushes after each op) bit for
// bit.  The min keeps NaN like jnp.min / torch.amin (fminf would drop
// it, hiding a diverged message from the NaN guards).
//
// Layout: the JAX layout, contiguous costs [F,D,D] and v2f [F,2,D]
// float32 in, f2v [F,2,D] float32 out (allocated by the wrapper).  A
// second entry, binary_factor_update_lane_launch (below), reads the
// lane layout, factors on the minor axis.
//
// Bound: memory.  Per factor the kernel must read 4*(D*D + 2D) bytes and
// write 4*2D bytes: 84 B at D=3, i.e. ~1.26 MB for the 15k-factor
// flagship bucket (~0.4 us at 3.35 TB/s, far under a launch, so that
// shape is launch-bound) and ~126 MB for the 1.5M-factor scale shape
// (~38 us).  Its arithmetic, 3*2*D*D ops per factor, is negligible.
//
// Design for D = 1..8 (D a template parameter, so every loop unrolls
// and the messages and running minima live in registers): one thread
// per factor, a block of kFactors factors.
//   1. The block stages its contiguous slabs of costs (kFactors*D*D
//      floats) and v2f (kFactors*2D floats) into shared memory with
//      coalesced 16-byte loads, all issued before the first store to
//      shared memory, so each table element and message crosses
//      DRAM->SM once (the first design loaded every table element twice
//      and every message D+1 times, in scattered 4-byte loads).
//   2. Each thread computes its factor's 2D outputs from shared memory.
//      Where a factor's stride (D*D or 2D floats) would make the 32
//      lanes of a warp, each reading its own factor, collide more than
//      4 ways on the banks (D = 4 and 8), it is padded to an odd stride
//      (see smem_stride).
//   3. The thread writes its outputs over its own messages in shared
//      memory, and the block stores the slab with coalesced 16-byte
//      stores.
// The ragged last block and unaligned tensors (a view at an odd
// offset) take the same path with 4-byte copies for what does not fill
// an aligned 16-byte vector.  Index math is 32-bit inside a block; the
// block's base offset is 64-bit.
//
// D > 8 goes to the generic kernel: one thread per output element,
// looping over the runtime D (the first design, with 32-bit index math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFactors = 128;  // factors (and threads) per block

// Float adds and subtracts as PTX with .ftz: a subnormal result (or
// input) is flushed to a zero of its sign, as XLA:CPU and the TPU do for
// the reference; inline asm is never contracted or reordered by nvcc.
__device__ __forceinline__ float fadd_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fsub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_keep_nan(float a, float b) {
  // a if a < b or a is NaN, else b (which is NaN whenever b is NaN).
  return (a < b || a != a) ? a : b;
}

// Shared-memory stride of a factor's W floats.  Each thread of a warp
// reads its own factor, so a stride with gcd(W, 32) = g costs g-way bank
// conflicts.  Padding to W + 1 (odd) removes them, but a padded slab can
// no longer be staged with 16-byte shared stores: its 4-byte stores then
// conflict 4 ways.  So pad only where g > 4: costs at D = 4 and 8,
// messages at D = 4 and 8.
__host__ __device__ constexpr int gcd32(int n) {
  return n % 32 == 0 ? 32 : n % 16 == 0 ? 16 : n % 8 == 0 ? 8
       : n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}
__host__ __device__ constexpr int smem_stride(int w) {
  return gcd32(w) > 4 ? w + 1 : w;
}

// Slot in shared memory of element e of a slab of W-float records.
template <int W, int S>
__device__ __forceinline__ int slot(int e) {
  if constexpr (S == W) {
    return e;
  } else {
    return (e / W) * S + e % W;
  }
}

// Copy n floats of src (one block's contiguous slab) into shared memory,
// record by record at stride S.  Every 16-byte load is issued before the
// first shared store.
template <int W, int S, int kVec>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         float* dst, int n) {
  const int tid = threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4 buf[kVec];
#pragma unroll
  for (int it = 0; it < kVec; ++it) {
    const int k = tid + it * kFactors;
    if (k < n4) buf[it] = __ldg(src4 + k);
  }
#pragma unroll
  for (int it = 0; it < kVec; ++it) {
    const int k = tid + it * kFactors;
    if (k < n4) {
      if constexpr (S == W) {
        reinterpret_cast<float4*>(dst)[k] = buf[it];
      } else {
        dst[slot<W, S>(4 * k)] = buf[it].x;
        dst[slot<W, S>(4 * k + 1)] = buf[it].y;
        dst[slot<W, S>(4 * k + 2)] = buf[it].z;
        dst[slot<W, S>(4 * k + 3)] = buf[it].w;
      }
    }
  }
  for (int e = 4 * n4 + tid; e < n; e += kFactors) {
    dst[slot<W, S>(e)] = __ldg(src + e);
  }
}

// The reverse of stage_in: n floats from shared memory to dst.
template <int W, int S, int kVec>
__device__ __forceinline__ void stage_out(const float* src,
                                          float* __restrict__ dst, int n) {
  const int tid = threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int it = 0; it < kVec; ++it) {
    const int k = tid + it * kFactors;
    if (k < n4) {
      if constexpr (S == W) {
        dst4[k] = reinterpret_cast<const float4*>(src)[k];
      } else {
        dst4[k] = make_float4(src[slot<W, S>(4 * k)],
                              src[slot<W, S>(4 * k + 1)],
                              src[slot<W, S>(4 * k + 2)],
                              src[slot<W, S>(4 * k + 3)]);
      }
    }
  }
  for (int e = 4 * n4 + tid; e < n; e += kFactors) {
    dst[e] = src[slot<W, S>(e)];
  }
}

template <int D>
__global__ void __launch_bounds__(kFactors)
    binary_factor_update_kernel(const float* __restrict__ costs,
                                const float* __restrict__ v2f,
                                float* __restrict__ out, int n_factors) {
  constexpr int kC = D * D;            // table floats per factor
  constexpr int kM = 2 * D;            // message floats per factor
  constexpr int kSC = smem_stride(kC);  // strides in shared memory
  constexpr int kSM = smem_stride(kM);
  // 16-byte vectors per thread for a full block's slab.
  constexpr int kVecC = (kFactors * kC / 4 + kFactors - 1) / kFactors;
  constexpr int kVecM = (kFactors * kM / 4 + kFactors - 1) / kFactors;
  __shared__ __align__(16) float s_c[kFactors * kSC];
  __shared__ __align__(16) float s_m[kFactors * kSM];

  const int f0 = blockIdx.x * kFactors;
  const int nf = min(kFactors, n_factors - f0);
  const float* c_blk = costs + static_cast<int64_t>(f0) * kC;
  const float* m_blk = v2f + static_cast<int64_t>(f0) * kM;
  float* o_blk = out + static_cast<int64_t>(f0) * kM;

  stage_in<kC, kSC, kVecC>(c_blk, s_c, nf * kC);
  stage_in<kM, kSM, kVecM>(m_blk, s_m, nf * kM);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < nf) {
    const float* c = s_c + t * kSC;
    float* m = s_m + t * kSM;
    float m0[D], m1[D], row[D], col[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m0[i] = m[i];
      m1[i] = m[D + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float v = fadd_ftz(fadd_ftz(c[i * D + j], m0[i]), m1[j]);
        row[i] = j == 0 ? v : min_keep_nan(row[i], v);
        col[j] = i == 0 ? v : min_keep_nan(col[j], v);
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = fsub_ftz(row[i], m0[i]);
      m[D + i] = fsub_ftz(col[i], m1[i]);
    }
  }
  __syncthreads();
  stage_out<kM, kSM, kVecM>(s_m, o_blk, nf * kM);
}

// Any D: one thread per output element (f, p, i), looping over the
// reduced axis in the same order.  n_out = F*2*D < 2^31.
__global__ void binary_factor_update_generic(const float* __restrict__ costs,
                                             const float* __restrict__ v2f,
                                             float* __restrict__ out,
                                             int n_out, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int fp = t / d;
  const int i = t - fp * d;
  const int f = fp >> 1;
  const int p = fp & 1;
  const float* c = costs + static_cast<int64_t>(f) * d * d;
  const float* m0 = v2f + static_cast<int64_t>(f) * 2 * d;
  const float* m1 = m0 + d;
  float acc;
  float own;
  if (p == 0) {
    // To scope position 0: reduce row i over j.
    own = m0[i];
    const float* row = c + i * d;
    acc = fadd_ftz(fadd_ftz(row[0], own), m1[0]);
    for (int j = 1; j < d; ++j) {
      acc = min_keep_nan(acc, fadd_ftz(fadd_ftz(row[j], own), m1[j]));
    }
  } else {
    // To scope position 1: reduce column i over the rows.
    own = m1[i];
    acc = fadd_ftz(fadd_ftz(c[i], m0[0]), own);
    for (int r = 1; r < d; ++r) {
      acc = min_keep_nan(acc, fadd_ftz(fadd_ftz(c[r * d + i], m0[r]), own));
    }
  }
  out[t] = fsub_ftz(acc, own);
}

template <int D>
void launch_d(const float* costs, const float* v2f, float* out,
              int n_factors, cudaStream_t stream) {
  const int blocks = (n_factors + kFactors - 1) / kFactors;
  binary_factor_update_kernel<D><<<blocks, kFactors, 0, stream>>>(
      costs, v2f, out, n_factors);
}

// ---------------------------------------------------------------------
// The lane-major entry (ops/maxsum_lane.py: the Pallas kernel's own
// block layout, factors on the minor axis): costs [D, D, F] and v2f
// [D, 2, F] float32 in, f2v [D, 2, F] out, with the edge entry's
// arithmetic in its order:
//
//   t[i,j,f]   = (costs[i,j,f] + v2f[i,0,f]) + v2f[j,1,f]
//   out[i,0,f] = min_j t[i,j,f] - v2f[i,0,f]     (j = 0, 1, ... in order)
//   out[j,1,f] = min_i t[i,j,f] - v2f[j,1,f]     (i = 0, 1, ... in order)
//
// Every element of a factor lies F floats from the next, so consecutive
// threads of a warp, one factor each, read and write consecutive floats:
// each load and store is coalesced as it stands, with no staging, any
// F (a ragged last warp just masks) and any 4-byte alignment of the
// views.  D = 1..8: one thread per factor, D a template parameter, the
// messages and running minima in registers.  D > 8: one thread per
// output element (p, i, f), f fastest, looping over the runtime D.
//
// Bound: memory, as the edge entry: per factor 4*(D*D + 2D) bytes read
// and 4*2D written.

template <int D>
__global__ void __launch_bounds__(256)
    binary_factor_update_lane_kernel(const float* __restrict__ costs,
                                     const float* __restrict__ v2f,
                                     float* __restrict__ out, int n_factors) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_factors) return;
  const int64_t F = n_factors;
  float m0[D], m1[D], row[D], col[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m0[i] = __ldg(v2f + (2 * i) * F + f);
    m1[i] = __ldg(v2f + (2 * i + 1) * F + f);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float c = __ldg(costs + (i * D + j) * F + f);
      const float v = fadd_ftz(fadd_ftz(c, m0[i]), m1[j]);
      row[i] = j == 0 ? v : min_keep_nan(row[i], v);
      col[j] = i == 0 ? v : min_keep_nan(col[j], v);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    out[(2 * i) * F + f] = fsub_ftz(row[i], m0[i]);
    out[(2 * i + 1) * F + f] = fsub_ftz(col[i], m1[i]);
  }
}

// Any D: thread t is output element (i, p, f) of [D, 2, F], f fastest.
__global__ void binary_factor_update_lane_generic(
    const float* __restrict__ costs, const float* __restrict__ v2f,
    float* __restrict__ out, int n_factors, int d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t F = n_factors;
  if (t >= 2 * d * F) return;
  const int64_t f = t % F;
  const int ip = static_cast<int>(t / F);
  const int i = ip >> 1;
  const int p = ip & 1;
  float acc = 0.0f, own;
  if (p == 0) {
    // To scope position 0: reduce row i over j.
    own = __ldg(v2f + (2 * i) * F + f);
    for (int j = 0; j < d; ++j) {
      const float v = fadd_ftz(
          fadd_ftz(__ldg(costs + (static_cast<int64_t>(i) * d + j) * F + f),
                   own),
          __ldg(v2f + (2 * j + 1) * F + f));
      acc = j == 0 ? v : min_keep_nan(acc, v);
    }
  } else {
    // To scope position 1: reduce column i over the rows.
    own = __ldg(v2f + (2 * i + 1) * F + f);
    for (int r = 0; r < d; ++r) {
      const float v = fadd_ftz(
          fadd_ftz(__ldg(costs + (static_cast<int64_t>(r) * d + i) * F + f),
                   __ldg(v2f + (2 * r) * F + f)),
          own);
      acc = r == 0 ? v : min_keep_nan(acc, v);
    }
  }
  out[t] = fsub_ftz(acc, own);
}

template <int D>
void launch_lane_d(const float* costs, const float* v2f, float* out,
                   int n_factors, cudaStream_t stream) {
  const int threads = 256;
  binary_factor_update_lane_kernel<D>
      <<<(n_factors + threads - 1) / threads, threads, 0, stream>>>(
          costs, v2f, out, n_factors);
}

}  // namespace

extern "C" int binary_factor_update_launch(const float* costs,
                                           const float* v2f, float* out,
                                           int n_factors, int d,
                                           cudaStream_t stream) {
  if (n_factors == 0 || d == 0) return 0;
  switch (d) {
    case 1: launch_d<1>(costs, v2f, out, n_factors, stream); break;
    case 2: launch_d<2>(costs, v2f, out, n_factors, stream); break;
    case 3: launch_d<3>(costs, v2f, out, n_factors, stream); break;
    case 4: launch_d<4>(costs, v2f, out, n_factors, stream); break;
    case 5: launch_d<5>(costs, v2f, out, n_factors, stream); break;
    case 6: launch_d<6>(costs, v2f, out, n_factors, stream); break;
    case 7: launch_d<7>(costs, v2f, out, n_factors, stream); break;
    case 8: launch_d<8>(costs, v2f, out, n_factors, stream); break;
    default: {
      const int n_out = n_factors * 2 * d;
      const int threads = 256;
      binary_factor_update_generic<<<(n_out + threads - 1) / threads,
                                     threads, 0, stream>>>(
          costs, v2f, out, n_out, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binary_factor_update_lane_launch(const float* costs,
                                                const float* v2f,
                                                float* out, int n_factors,
                                                int d,
                                                cudaStream_t stream) {
  if (n_factors == 0 || d == 0) return 0;
  switch (d) {
    case 1: launch_lane_d<1>(costs, v2f, out, n_factors, stream); break;
    case 2: launch_lane_d<2>(costs, v2f, out, n_factors, stream); break;
    case 3: launch_lane_d<3>(costs, v2f, out, n_factors, stream); break;
    case 4: launch_lane_d<4>(costs, v2f, out, n_factors, stream); break;
    case 5: launch_lane_d<5>(costs, v2f, out, n_factors, stream); break;
    case 6: launch_lane_d<6>(costs, v2f, out, n_factors, stream); break;
    case 7: launch_lane_d<7>(costs, v2f, out, n_factors, stream); break;
    case 8: launch_lane_d<8>(costs, v2f, out, n_factors, stream); break;
    default: {
      const int64_t n_out = static_cast<int64_t>(n_factors) * 2 * d;
      const int threads = 256;
      binary_factor_update_lane_generic<<<
          static_cast<unsigned>((n_out + threads - 1) / threads), threads,
          0, stream>>>(costs, v2f, out, n_factors, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
