// MaxSum's per-edge update, fused: the whole variable side of one bucket
// (v2f_update) or the send epilogue alone (send_update), one launch each.
//
// Replaces the jnp ops of pydcop_tpu/ops/maxsum.py:463 var_to_factor,
// :494 _damp, :120 _send_or_suppress and :100 _edge_match (ops/
// var_update.py holds the plain version, and the wrapper).  That is jnp
// code, not a Pallas kernel; it became a hand kernel because of a fault:
// XLA:CPU and the TPU flush subnormal results to zero at every
// operation, so a plain torch superstep either differs from the
// reference where a subnormal appears (values below 2^-102 meeting in a
// sum, a difference or the mean) or pays ~3 launches per flushed
// operation.  Here every float operation is one PTX instruction with
// .ftz (add/sub/mul/div/fma .rn.ftz.f32), and the file is also built
// with -ftz=true; no product is left for nvcc to contract into an FMA
// (inline asm is opaque to it), and the division is IEEE (div.rn).
//
// For each edge (f, p) of the bucket, one thread:
//   v2f only:
//   1. reads its variable v = var_ids[f, p], the rows beliefs[v] and
//      sums[v], and its own factor message m = f2v[f, p];
//   2. x_k = valid_k ? sums[v,k] - m_k : 0, and their sum over the
//      domain in the order XLA sums them (ops/var_update.py sum_last):
//      left to right up to D = 32 (from x_0); above 32 in windows of 32
//      (the front padded by ((-D) mod 32) / 2 empty slots, each window
//      from zero, the window sums left to right); with `fused` at
//      D = 28..31 lanes of 8 over the first 24 slots and the rest one by
//      one, at D = 32 lanes of 16; avg = sum / max(#valid, 1);
//   3. cand_k = valid_k ? (beliefs[v,k] - m_k) - avg : BIG;
//   send_update: cand_k = ftz(f2v[f, p, k]) (the factor side's candidate);
//   both:
//   4. damps against the last sent message o: nothing at cycle 0 or with
//      mode 0; mode 1 (damping 0.5): (o + cand) * 0.5; mode 2:
//      fma(damping, o, (1 - damping) * cand);
//   5. approx-match on every valid slot, 2|n - o| < stability * |n + o|
//      or n == o, and not at cycle 0; sends n unless the edge matched and
//      has re-sent SAME_COUNT times already (then keeps o); count + 1 up
//      to SAME_COUNT + 1 on a match, else 1;
//   6. a live edge (any valid slot) that did not match writes 0 into the
//      `stable` flag, which the superstep set to (cycle != 0) before the
//      first launch: the reference's all_match & ~first.
// The cycle is read on the device, so no launch reads the host.
//
// Layout: beliefs, sums [V+1, D] f32; f2v, prev, out [F, a, D] f32;
// count, out_count [F, a] int8; var_ids [F, a] int64 (the placement's
// index dtype); var_valid [V+1, D]
// bool (bytes); cycle 0-d int32; stable 0-d bool.
//
// Bound: memory.  Per edge the kernel must read D*4 (f2v) + D*4 (prev)
// + 8 (var_ids) + 1 (count) bytes and write D*4 + 1, and per variable
// row 2*D*4 (beliefs, sums) + D (var_valid) once: ~1.2 MB at the
// 10k-variable flagship (launch-bound) and ~120 MB at the 1M-variable
// scale graph.  The design takes one thread per edge and reads its
// variable's rows through L1/L2 (a 12-byte row per edge at D = 3, in
// the bucket's random variable order); the message rows are read in
// edge order.  D = 1..8 is templated (var_update_small: the row in
// registers, every load issued up front).  Above 8 the domain loops
// run at the runtime D (var_update_kernel): the thread reads its slots
// twice (mean, then update) and the kept message a second time only on
// an edge that goes quiet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;
constexpr int kSameCount = 4;
constexpr float kBig = 1e9f;
constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float fadd(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fsub(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fmul(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fdiv(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float ffma(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
// A subnormal becomes a zero of its sign; NaN and infinities are kept
// bit for bit (an arithmetic flush would make a NaN canonical).
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kFltMin
             ? __int_as_float(__float_as_int(x) & 0x80000000)
             : x;
}

struct Args {
  const float* beliefs;  // null: send_update (f2v holds the candidates)
  const float* sums;
  const float* f2v;
  const float* prev;
  const int8_t* count;
  const int64_t* var_ids;
  const uint8_t* var_valid;
  const int* cycle;
  float* out;
  int8_t* out_count;
  uint8_t* stable;
  int n_edges;
  int d;
  int mode;         // 0 none, 1 (o + n) * 0.5, 2 fma
  float damping;
  float one_minus;  // float32(1 - damping), as the plain version rounds it
  float stability;
  int fused;
};

// The mean's term k: the other factors' messages on a valid slot, else 0.
__device__ __forceinline__ float term(const float* s, const float* m,
                                      const uint8_t* valid, int k) {
  return valid[k] ? fsub(__ldg(s + k), __ldg(m + k)) : 0.0f;
}

// LLVM's vectorised sum: kWidth lanes from zero, lane j adding slots
// j, j + kWidth, ... below kHead; lanes folded by halves; then slots
// kHead .. d-1 one by one.
template <int kWidth, int kHead>
__device__ __forceinline__ float lane_sum(const float* s, const float* m,
                                          const uint8_t* valid, int d) {
  float lanes[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = j; k < kHead; k += kWidth) acc = fadd(acc, term(s, m, valid, k));
    lanes[j] = acc;
  }
#pragma unroll
  for (int half = kWidth / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int i = 0; i < half; ++i) lanes[i] = fadd(lanes[i], lanes[i + half]);
  }
  float acc = lanes[0];
  for (int k = kHead; k < d; ++k) acc = fadd(acc, term(s, m, valid, k));
  return acc;
}

// The domain sum of the terms in XLA's order (ops/var_update.py sum_last).
__device__ float domain_sum(const float* s, const float* m,
                            const uint8_t* valid, int d, bool fused) {
  if (d > kWindow) {
    const int pad = ((kWindow - d % kWindow) % kWindow) / 2;
    float total = 0.0f;
    bool any = false;
    for (int lo = -pad; lo < d; lo += kWindow) {
      const int hi = min(lo + kWindow, d);
      float w = 0.0f;
      for (int k = max(lo, 0); k < hi; ++k) w = fadd(w, term(s, m, valid, k));
      total = any ? fadd(total, w) : w;
      any = true;
    }
    return total;
  }
  if (fused && d == kWindow) return lane_sum<16, 32>(s, m, valid, d);
  if (fused && d >= 28) return lane_sum<8, 24>(s, m, valid, d);
  float acc = term(s, m, valid, 0);
  for (int k = 1; k < d; ++k) acc = fadd(acc, term(s, m, valid, k));
  return acc;
}

template <bool kVar>
__global__ void __launch_bounds__(kThreads) var_update_kernel(const Args a) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.n_edges) return;
  const int d = a.d;
  const bool first = __ldg(a.cycle) == 0;
  const int v = static_cast<int>(__ldg(a.var_ids + e));
  const uint8_t* valid = a.var_valid + static_cast<int64_t>(v) * d;
  const float* m = a.f2v + static_cast<int64_t>(e) * d;
  const float* o = a.prev + static_cast<int64_t>(e) * d;
  float* out = a.out + static_cast<int64_t>(e) * d;

  float avg = 0.0f;
  const float* bel = nullptr;
  if constexpr (kVar) {
    const float* s = a.sums + static_cast<int64_t>(v) * d;
    bel = a.beliefs + static_cast<int64_t>(v) * d;
    int n_valid = 0;
    for (int k = 0; k < d; ++k) n_valid += valid[k] ? 1 : 0;
    avg = fdiv(domain_sum(s, m, valid, d, a.fused != 0),
               static_cast<float>(max(n_valid, 1)));
  }

  bool live = false;
  bool all_ok = true;
  for (int k = 0; k < d; ++k) {
    const bool ok_slot = valid[k] != 0;
    float cand;
    if constexpr (kVar) {
      cand = ok_slot ? fsub(fsub(__ldg(bel + k), __ldg(m + k)), avg) : kBig;
    } else {
      cand = ftz(__ldg(m + k));
    }
    const float old = __ldg(o + k);
    if (!first) {
      if (a.mode == 1) {
        cand = fmul(fadd(old, cand), 0.5f);
      } else if (a.mode == 2) {
        cand = ffma(a.damping, old, fmul(a.one_minus, cand));
      }
    }
    out[k] = cand;
    const float delta = fabsf(fsub(cand, old));
    const float sum = fabsf(fadd(cand, old));
    const bool ok = fmul(2.0f, delta) < fmul(a.stability, sum) || delta == 0.0f;
    all_ok = all_ok && (ok || !ok_slot);
    live = live || ok_slot;
  }
  const bool match = all_ok && !first;
  const int8_t cnt = a.count[e];
  if (match && cnt >= kSameCount) {
    for (int k = 0; k < d; ++k) out[k] = __ldg(o + k);
  }
  a.out_count[e] = match ? static_cast<int8_t>(min(cnt + 1, kSameCount + 1))
                         : static_cast<int8_t>(1);
  if (live && !match) *a.stable = 0;
}

// D = 1..8 (the domain a template parameter): the same steps with the
// row in registers.  Every load of the edge is issued before the first
// use (the loops unroll), so a thread waits once per dependent step
// (var_ids, then the rows) instead of once per slot, and the sent row
// is written once.  At D <= 8 the domain mean is always the left-to-
// right sum (the windowed and lane forms start at D = 28).
template <int D, bool kVar>
__global__ void __launch_bounds__(kThreads)
    var_update_small(const Args a) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.n_edges) return;
  const bool first = __ldg(a.cycle) == 0;
  const int v = static_cast<int>(__ldg(a.var_ids + e));
  const int64_t row = static_cast<int64_t>(v) * D;
  const int64_t edge = static_cast<int64_t>(e) * D;
  bool valid[D];
  float m[D], o[D], cand[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    valid[k] = a.var_valid[row + k] != 0;
    m[k] = __ldg(a.f2v + edge + k);
    o[k] = __ldg(a.prev + edge + k);
  }
  if constexpr (kVar) {
    float s[D], bel[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      s[k] = __ldg(a.sums + row + k);
      bel[k] = __ldg(a.beliefs + row + k);
    }
    float acc = valid[0] ? fsub(s[0], m[0]) : 0.0f;
    int n_valid = valid[0] ? 1 : 0;
#pragma unroll
    for (int k = 1; k < D; ++k) {
      acc = fadd(acc, valid[k] ? fsub(s[k], m[k]) : 0.0f);
      n_valid += valid[k] ? 1 : 0;
    }
    const float avg = fdiv(acc, static_cast<float>(max(n_valid, 1)));
#pragma unroll
    for (int k = 0; k < D; ++k) {
      cand[k] = valid[k] ? fsub(fsub(bel[k], m[k]), avg) : kBig;
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) cand[k] = ftz(m[k]);
  }
  bool live = false;
  bool all_ok = true;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (!first) {
      if (a.mode == 1) {
        cand[k] = fmul(fadd(o[k], cand[k]), 0.5f);
      } else if (a.mode == 2) {
        cand[k] = ffma(a.damping, o[k], fmul(a.one_minus, cand[k]));
      }
    }
    const float delta = fabsf(fsub(cand[k], o[k]));
    const float sum = fabsf(fadd(cand[k], o[k]));
    const bool ok =
        fmul(2.0f, delta) < fmul(a.stability, sum) || delta == 0.0f;
    all_ok = all_ok && (ok || !valid[k]);
    live = live || valid[k];
  }
  const bool match = all_ok && !first;
  const int8_t cnt = a.count[e];
  const bool keep = match && cnt >= kSameCount;
#pragma unroll
  for (int k = 0; k < D; ++k) a.out[edge + k] = keep ? o[k] : cand[k];
  a.out_count[e] = match ? static_cast<int8_t>(min(cnt + 1, kSameCount + 1))
                         : static_cast<int8_t>(1);
  if (live && !match) *a.stable = 0;
}

template <bool kVar>
void launch(const Args& a, int blocks, cudaStream_t stream) {
  switch (a.d) {
    case 1: var_update_small<1, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 2: var_update_small<2, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 3: var_update_small<3, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 4: var_update_small<4, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 5: var_update_small<5, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 6: var_update_small<6, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 7: var_update_small<7, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    case 8: var_update_small<8, kVar><<<blocks, kThreads, 0, stream>>>(a); break;
    default: var_update_kernel<kVar><<<blocks, kThreads, 0, stream>>>(a);
  }
}

}  // namespace

// beliefs/sums null: send_update (f2v holds the candidates).  mode: 0 no
// damping, 1 (o + n) * 0.5, 2 fma(damping, o, one_minus * n).  Returns a
// cudaError_t (0 when the launch was taken).
extern "C" int var_update_launch(const float* beliefs, const float* sums,
                                 const float* f2v, const float* prev,
                                 const int8_t* count, const int64_t* var_ids,
                                 const uint8_t* var_valid, const int* cycle,
                                 float* out, int8_t* out_count,
                                 uint8_t* stable, int n_edges, int d,
                                 int mode, float damping, float one_minus,
                                 float stability, int var_side, int fused,
                                 cudaStream_t stream) {
  if (n_edges == 0) return 0;
  if (d < 1 || mode < 0 || mode > 2 || (var_side && (!beliefs || !sums))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{beliefs, sums,  f2v,     prev,    count,    var_ids,
         var_valid, cycle, out,   out_count, stable, n_edges,
         d,       mode,  damping, one_minus, stability, fused};
  const int blocks = (n_edges + kThreads - 1) / kThreads;
  if (var_side) {
    launch<true>(a, blocks, stream);
  } else {
    launch<false>(a, blocks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
