// The lane layout's per-edge update, fused: the whole variable side of
// one bucket (lane_v2f) or the send epilogue alone (lane_send), one
// launch each, on the lane-major messages [D, a, F] where they lie.
//
// Replaces the jnp ops of pydcop_tpu/ops/maxsum_lane.py:332
// var_to_factor, :359 _damp, :286 _send_or_suppress and :277
// _edge_match, which superstep (:366) runs (ops/lane_var_update.py holds
// the plain version, and the wrapper).  That is jnp code, not a Pallas
// kernel; it became a hand kernel on H100 evidence: as plain torch the
// lane variable side was ~120 launches a cycle, most of the lane
// layout's 2.5-2.9 ms a cycle.  Every float operation is one PTX
// instruction with .ftz (add/sub/mul/div/fma .rn.ftz.f32), as XLA:CPU
// flushes the reference's; no product is left for nvcc to contract into
// an FMA, and the division is IEEE (div.rn).
//
// For each edge e = p * F + f of the bucket (its slot k is element
// k * a*F + e of the messages), one thread:
//   lane_v2f only:
//   1. reads its variable v = var_ids[e] and the row v of the table
//      [V+1, 2P] that csrc/lane_sum.cu writes (beliefs[v, 0..D), then
//      sums[v, 0..D), each padded with zeros to P floats): one
//      aligned 32- or 64-byte gather an edge (16-byte loads), not 2D
//      4-byte ones from the lane-major [D, V+1];
//   2. x_k = valid_k ? sums[v,k] - m_k : 0, summed over the domain in
//      the lane plain version's order (maxsum_lane._sum_domain): left to
//      right from x_0 up to D = 32, above 32 in windows of 32 (the front
//      padded by ((-D) mod 32) / 2 empty slots, each window from zero,
//      the window sums left to right); avg = sum / max(#valid, 1);
//   3. cand_k = valid_k ? (beliefs[v,k] - m_k) - avg : BIG;
//   lane_send: cand_k = ftz(f2v[k, e]) (the factor side's candidate);
//   both:
//   4. damps against the last sent message o: nothing at cycle 0 or with
//      mode 0; mode 1 (damping 0.5): (o + cand) * 0.5; mode 2:
//      fma(damping, o, (1 - damping) * cand) (ops/var_update.py damp);
//   5. approx-match on every valid slot, 2|n - o| < stability * |n + o|
//      or n == o, and not at cycle 0; sends n unless the edge matched and
//      has re-sent SAME_COUNT times already (then keeps o); count + 1 up
//      to SAME_COUNT + 1 on a match, else 1;
//   6. a live edge (any valid slot) that did not match has its block
//      write 0 into `stable` (once per block, __syncthreads_or), which
//      the superstep set to (cycle != 0) before the first launch: the
//      reference's all_match & ~first.  The cycle is read on the device,
//      so no launch reads the host.
//
// Layout: table [V+1, 2P] f32 (P the caller's, ops/lane_sum.py
// row_floats: at least D, a multiple of 4 up to D = 8); f2v, prev, out
// [D, a*F] f32; count,
// out_count [a*F] int8; var_ids [a*F] int32 (the placement's
// var_ids32); edge_valid [a*F] uint8, bit k = var_valid[k, var_ids]
// (D <= 8, placed once by device.to_lane_device_graph); var_valid
// [D, V+1] bool (bytes, D > 8 only); cycle 0-d int32; stable 0-d bool.
//
// Bound: memory.  Per edge the work reads its message slots and its
// last sent slots (2 * 4D bytes), its count and validity (2 bytes) and,
// v2f only, its variable's index (4 bytes), and writes the sent slots
// and count (4D + 1); per variable v2f reads its beliefs and sums once
// (8D):
// ~141 MB for v2f and ~117 MB for send at the 1M-variable scale graph
// (D = 3, 3M edges), 0.042 and 0.035 ms at 3.35 TB/s.
//
// Design.  Lane-major messages need no staging: slot k of consecutive
// edges is consecutive, so a warp's loads and stores of one slot are
// one coalesced 128-byte access, as are the 1- and 4-byte per-edge
// arrays.  D = 1..8 is a template parameter, the slots in registers;
// each thread issues its table row's 16-byte loads (one 32-byte sector
// at D <= 4) right after its index, before any add, and reads and
// writes the streamed arrays evict-first so the table rows stay in L2
// (v2f 0.092 -> 0.083 ms at scale on an H100).  Above D = 8 one
// thread takes one edge at the runtime D and reads var_valid through
// the index.

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
// A subnormal becomes a zero of its sign; NaN and infinities are kept.
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kFltMin
             ? __int_as_float(__float_as_int(x) & 0x80000000)
             : x;
}

// The streamed per-edge arrays (messages, counts, ids, validity) are
// read and written evict-first (ld/st.global.cs), so the gathered
// table rows keep their place in L2.
template <bool kStream, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kStream) return __ldcs(p); else return __ldg(p);
}
template <bool kStream, typename T>
__device__ __forceinline__ void st(T* p, T v) {
  if constexpr (kStream) __stcs(p, v); else *p = v;
}

struct Args {
  const float* table;  // null: lane_send (f2v holds the candidates)
  const float* f2v;
  const float* prev;
  const int8_t* count;
  const int* var_ids;         // int32; null for lane_send at D <= 8
  const uint8_t* edge_valid;  // D <= 8
  const uint8_t* var_valid;   // [D, V+1], D > 8
  const int* cycle;
  float* out;
  int8_t* out_count;
  uint8_t* stable;
  int n_edges;  // a * F
  int n_rows;   // V + 1
  int d;
  int p;        // floats in each half of a table row
  int mode;         // 0 none, 1 (o + n) * 0.5, 2 fma
  float damping;
  float one_minus;  // float32(1 - damping), as the plain version rounds it
  float stability;
};

// Damping, approx-match, SAME_COUNT and the count for one edge whose
// candidates are cand[0..d) (D = 0: the runtime a.d, slots strided by
// a.n_edges in `o` and `out`).  Returns whether the edge is live and
// unmatched.
template <int D, bool kStream = false>
__device__ __forceinline__ bool epilogue(const Args& a, int e, bool first,
                                         float* cand, const float* old,
                                         const bool* valid) {
  const int d = D > 0 ? D : a.d;
  bool live = false;
  bool all_ok = true;
  for (int k = 0; k < d; ++k) {
    float n = cand[k];
    const float o = old[k];
    if (!first) {
      if (a.mode == 1) {
        n = fmul(fadd(o, n), 0.5f);
      } else if (a.mode == 2) {
        n = ffma(a.damping, o, fmul(a.one_minus, n));
      }
    }
    cand[k] = n;
    const float delta = fabsf(fsub(n, o));
    const float sum = fabsf(fadd(n, o));
    const bool ok = fmul(2.0f, delta) < fmul(a.stability, sum) || delta == 0.0f;
    all_ok = all_ok && (ok || !valid[k]);
    live = live || valid[k];
  }
  const bool match = all_ok && !first;
  const int8_t cnt = ld<kStream>(a.count + e);
  const bool keep = match && cnt >= kSameCount;
  for (int k = 0; k < d; ++k)
    st<kStream>(a.out + static_cast<int64_t>(k) * a.n_edges + e,
                keep ? old[k] : cand[k]);
  st<kStream>(a.out_count + e,
              match ? static_cast<int8_t>(min(cnt + 1, kSameCount + 1))
                    : static_cast<int8_t>(1));
  return live && !match;
}

// Thread 0 reads the cycle for its block; after the barrier every
// thread reads whether it is the first.
__device__ __forceinline__ bool block_first(const int* cycle, int* flag) {
  if (threadIdx.x == 0) *flag = __ldg(cycle) == 0;
  __syncthreads();
  return *flag != 0;
}

template <int D, bool kVar>
__global__ void __launch_bounds__(kThreads) lane_update(const Args a) {
  constexpr bool kStream = true;
  __shared__ int first_flag;
  const bool first = block_first(a.cycle, &first_flag);
  const int e = blockIdx.x * kThreads + threadIdx.x;
  bool unmatched = false;
  if (e < a.n_edges) {
    // The table row: beliefs, then sums at P; the 16-byte vectors
    // that hold each half's D slots.
    constexpr int kVec = (D + 3) / 4;
    float bel[4 * kVec], sum[4 * kVec];
    if constexpr (kVar) {
      const float* r =
          a.table + static_cast<int64_t>(ld<kStream>(a.var_ids + e)) * 2 * a.p;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(r) + j);
        const float4 s = __ldg(reinterpret_cast<const float4*>(r + a.p) + j);
        bel[4 * j] = q.x;
        bel[4 * j + 1] = q.y;
        bel[4 * j + 2] = q.z;
        bel[4 * j + 3] = q.w;
        sum[4 * j] = s.x;
        sum[4 * j + 1] = s.y;
        sum[4 * j + 2] = s.z;
        sum[4 * j + 3] = s.w;
      }
    }
    const unsigned bits = ld<kStream>(a.edge_valid + e);
    float m[D], old[D], cand[D];
    bool valid[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      m[k] = ld<kStream>(a.f2v + static_cast<int64_t>(k) * a.n_edges + e);
      old[k] = ld<kStream>(a.prev + static_cast<int64_t>(k) * a.n_edges + e);
      valid[k] = (bits >> k) & 1u;
    }
    if constexpr (kVar) {
      float acc = 0.0f;
      int n_valid = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float x = valid[k] ? fsub(sum[k], m[k]) : 0.0f;
        acc = k == 0 ? x : fadd(acc, x);
        n_valid += valid[k] ? 1 : 0;
      }
      const float avg = fdiv(acc, static_cast<float>(max(n_valid, 1)));
#pragma unroll
      for (int k = 0; k < D; ++k)
        cand[k] = valid[k] ? fsub(fsub(bel[k], m[k]), avg) : kBig;
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) cand[k] = ftz(m[k]);
    }
    unmatched = epilogue<D, kStream>(a, e, first, cand, old, valid);
  }
  if (__syncthreads_or(unmatched) && threadIdx.x == 0) *a.stable = 0;
}

// The domain sum of the terms valid_k ? s_k - m_k : 0 in the lane plain
// version's order (maxsum_lane._sum_domain), at the runtime d.
__device__ float domain_sum(const float* s, const Args& a, int e,
                            const bool* valid, int d) {
  auto term = [&](int k) {
    return valid[k]
               ? fsub(__ldg(s + k),
                      __ldg(a.f2v + static_cast<int64_t>(k) * a.n_edges + e))
               : 0.0f;
  };
  if (d > kWindow) {
    const int pad = ((kWindow - d % kWindow) % kWindow) / 2;
    float total = 0.0f;
    bool any = false;
    for (int lo = -pad; lo < d; lo += kWindow) {
      const int hi = min(lo + kWindow, d);
      float w = 0.0f;
      for (int k = max(lo, 0); k < hi; ++k) w = fadd(w, term(k));
      total = any ? fadd(total, w) : w;
      any = true;
    }
    return total;
  }
  float acc = term(0);
  for (int k = 1; k < d; ++k) acc = fadd(acc, term(k));
  return acc;
}

// Above D = 8: the runtime d, validity through the index; the slots are
// held in local arrays of at most kMaxD.
constexpr int kMaxD = 256;

template <bool kVar>
__global__ void __launch_bounds__(kThreads) lane_update_generic(const Args a) {
  __shared__ int first_flag;
  const bool first = block_first(a.cycle, &first_flag);
  const int e = blockIdx.x * kThreads + threadIdx.x;
  bool unmatched = false;
  if (e < a.n_edges) {
    const int d = a.d;
    const int v = __ldg(a.var_ids + e);
    bool valid[kMaxD];
    float old[kMaxD], cand[kMaxD];
    int n_valid = 0;
    for (int k = 0; k < d; ++k) {
      valid[k] = a.var_valid[static_cast<int64_t>(k) * a.n_rows + v] != 0;
      n_valid += valid[k] ? 1 : 0;
      old[k] = __ldg(a.prev + static_cast<int64_t>(k) * a.n_edges + e);
    }
    if constexpr (kVar) {
      const float* row = a.table + static_cast<int64_t>(v) * 2 * a.p;
      const float avg = fdiv(domain_sum(row + a.p, a, e, valid, d),
                             static_cast<float>(max(n_valid, 1)));
      for (int k = 0; k < d; ++k) {
        const float m = __ldg(a.f2v + static_cast<int64_t>(k) * a.n_edges + e);
        cand[k] = valid[k] ? fsub(fsub(__ldg(row + k), m), avg) : kBig;
      }
    } else {
      for (int k = 0; k < d; ++k)
        cand[k] = ftz(__ldg(a.f2v + static_cast<int64_t>(k) * a.n_edges + e));
    }
    unmatched = epilogue<0>(a, e, first, cand, old, valid);
  }
  if (__syncthreads_or(unmatched) && threadIdx.x == 0) *a.stable = 0;
}

template <int D>
int launch_d(const Args& a, bool var, int blocks, cudaStream_t stream) {
  if (var) {
    lane_update<D, true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    lane_update<D, false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return 0;
}

}  // namespace

extern "C" int lane_var_update_launch(
    const float* table, const float* f2v, const float* prev,
    const int8_t* count, const int* var_ids, const uint8_t* edge_valid,
    const uint8_t* var_valid, const int* cycle, float* out,
    int8_t* out_count, uint8_t* stable, int n_edges, int n_rows, int d,
    int p, int mode, float damping, float one_minus, float stability,
    cudaStream_t stream) {
  if (d < 1 || d > kMaxD ||
      (table != nullptr && (p < d || (d <= 8 && p % 4 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges == 0) return 0;
  Args a;
  a.table = table;
  a.f2v = f2v;
  a.prev = prev;
  a.count = count;
  a.var_ids = var_ids;
  a.edge_valid = edge_valid;
  a.var_valid = var_valid;
  a.cycle = cycle;
  a.out = out;
  a.out_count = out_count;
  a.stable = stable;
  a.n_edges = n_edges;
  a.n_rows = n_rows;
  a.d = d;
  a.p = p;
  a.mode = mode;
  a.damping = damping;
  a.one_minus = one_minus;
  a.stability = stability;
  const bool var = table != nullptr;
  const int blocks = (n_edges + kThreads - 1) / kThreads;
  switch (d) {
    case 1: launch_d<1>(a, var, blocks, stream); break;
    case 2: launch_d<2>(a, var, blocks, stream); break;
    case 3: launch_d<3>(a, var, blocks, stream); break;
    case 4: launch_d<4>(a, var, blocks, stream); break;
    case 5: launch_d<5>(a, var, blocks, stream); break;
    case 6: launch_d<6>(a, var, blocks, stream); break;
    case 7: launch_d<7>(a, var, blocks, stream); break;
    case 8: launch_d<8>(a, var, blocks, stream); break;
    default:
      if (var) {
        lane_update_generic<true><<<blocks, kThreads, 0, stream>>>(a);
      } else {
        lane_update_generic<false><<<blocks, kThreads, 0, stream>>>(a);
      }
  }
  return static_cast<int>(cudaGetLastError());
}
