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
//   6. a live edge (any valid slot) that did not match has its block
//      write 0 into the `stable` flag, which the superstep set to
//      (cycle != 0) before the first launch: the reference's
//      all_match & ~first.
// The cycle is read on the device (at D <= 8 once per block), so no
// launch reads the host.
//
// Layout: beliefs, sums [V+1, D] f32; f2v, prev, out [F, a, D] f32;
// count, out_count [F, a] int8; var_ids [F, a] int32 (the placement's
// var_ids32); edge_valid [F, a] uint8, bit k = var_valid[var_ids, k]
// (D <= 8); var_valid [V+1, D] bool (bytes, D > 8 only); cycle 0-d
// int32; stable 0-d bool.
//
// Bound: memory.  Per edge the work reads its message row and its last
// sent row (2 * 4D bytes), its count and validity (2 bytes) and, v2f
// only, its variable's index (4 bytes), and writes the sent row and
// count (4D + 1); per variable row v2f reads beliefs and sums once
// (2 * 4D): ~153 MB for v2f and ~117 MB for send at the 1M-variable
// scale graph (D = 3, 3M edges), 0.046 and 0.035 ms at 3.35 TB/s;
// ~1.5 MB at the 10k-variable flagship, which is launch-bound.
//
// Design at D = 1..8 (var_update_tile, the domain a template
// parameter), one block per tile of kThreads * kItems edges:
// - the tile's message rows and last sent rows are staged into shared
//   memory by asynchronous 16-byte copies (cp.async, tagged evict-first
//   in L2 so the streamed rows do not push the gathered beliefs/sums
//   rows, 24 MB at scale, out of it), and the sent rows go back as one
//   tile of 16-byte streaming stores (st.global.cs), instead of D
//   strided 4-byte accesses per thread; 4-byte copies and stores cover
//   a tile that does not start or end on 16 bytes (a bucket may be a
//   view);
// - the 1- and 4-byte per-edge arrays (counts, edge_valid, int32 ids)
//   are read and written by each thread for its own edges, adjacent
//   lanes on adjacent edges (coalesced, no barrier before the gathers);
// - each thread takes kItems edges (a stride of kThreads apart) and
//   issues every edge's beliefs/sums row gathers (__ldg) while the
//   copies land, so several independent chains are in flight and the
//   tile costs about two memory round trips (ids, then rows);
// - validity is the per-edge bit mask edge_valid: no var_valid row and
//   no int64 index is read, and send_update reads no index at all;
// - `stable` is written at most once per block (__syncthreads_or of
//   "live and not matched"), not by every such edge: millions of
//   stores to one byte otherwise queue at one L2 slice.
// The wrapper picks kItems (ops/var_update.py tile_items): fewer edges
// a thread when a bucket is too small to give every SM a block.
// Above D = 8 (var_update_kernel) one thread takes one edge at the
// runtime D, reading its var_valid row through the int32 index; it
// reads its slots twice (mean, then update) and the kept message a
// second time only on an edge that goes quiet, and also writes
// `stable` once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // ops/var_update.py BLOCK_THREADS
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
  const int* var_ids;         // int32; null for send_update at D <= 8
  const uint8_t* edge_valid;  // D <= 8
  const uint8_t* var_valid;   // D > 8
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

// Each thread reads the cycle itself (one broadcast load beside its
// others), so no barrier holds the block before its first load.
template <bool kVar>
__global__ void __launch_bounds__(kThreads) var_update_kernel(const Args a) {
  const bool first = __ldg(a.cycle) == 0;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  bool unmatched = false;
  if (e < a.n_edges) {
    const int d = a.d;
    const int v = __ldg(a.var_ids + e);
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
      const bool ok =
          fmul(2.0f, delta) < fmul(a.stability, sum) || delta == 0.0f;
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
    unmatched = live && !match;
  }
  if (__syncthreads_or(unmatched) && threadIdx.x == 0) *a.stable = 0;
}

// ---- D = 1..8: edge tiles through shared memory -------------------------

// Thread 0 reads the cycle for its block; after the barrier every
// thread reads whether it is the first.
__device__ __forceinline__ bool block_first(const int* cycle, int* flag) {
  if (threadIdx.x == 0) *flag = __ldg(cycle) == 0;
  __syncthreads();
  return *flag != 0;
}

// Bytes of a shared-memory region for `bytes` bytes of a tile: 16 more,
// so the region can start at the global tile's address modulo 16.
__host__ __device__ constexpr int region_bytes(int bytes) {
  return (bytes + 16 + 15) / 16 * 16;
}

// The dynamic shared memory of one tile: its message rows and its last
// sent rows (the sent rows overwrite the message rows in place).
__host__ __device__ constexpr int tile_smem_bytes(int d, int items) {
  return 2 * region_bytes(kThreads * items * d * 4);
}

// A region's element 0 at `raw` plus the address of `g` modulo 16, so a
// 16-byte boundary of the global tile is one of the region too.
template <typename T>
__device__ __forceinline__ T* align_like(unsigned char* raw, const T* g) {
  return reinterpret_cast<T*>(raw + (reinterpret_cast<uintptr_t>(g) & 15));
}

// Elements before the first 16-byte boundary at or after `g`, at most n.
template <typename T>
__device__ __forceinline__ int head_elems(const T* g, int n) {
  const int bytes = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15);
  return min(n, bytes / static_cast<int>(sizeof(T)));
}

// An L2 policy that evicts first what it tags: the streamed rows, so
// they do not push the gathered beliefs/sums rows out of L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Asynchronous copies into shared memory (cp.async): no register is
// held while they land; copies_done() waits for all of a thread's.
__device__ __forceinline__ void copy16(float* s, const float* g,
                                       uint64_t policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
      :: "r"(dst), "l"(g), "l"(policy) : "memory");
}
__device__ __forceinline__ void copy4(float* s, const float* g) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(g) : "memory");
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
}

// Elements [0, n) of `g` into `s` (placed by align_like): 16-byte
// copies between g's 16-byte boundaries, 4-byte ones before the first
// and after the last.  Read `s` after copies_done() and a barrier.
__device__ __forceinline__ void stage_in(float* s, const float* g, int n,
                                         uint64_t policy) {
  const int head = head_elems(g, n);
  const int body = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += kThreads) copy4(s + i, g + i);
  for (int i = threadIdx.x; i < body; i += kThreads) {
    copy16(s + head + 4 * i, g + head + 4 * i, policy);
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads) {
    copy4(s + i, g + i);
  }
}

// Elements [0, n) of `s` to `g` with streaming stores, 16 bytes at a
// time between g's 16-byte boundaries; each 16 bytes read from shared
// memory in one load where `s` has g's address modulo 16 (a uniform
// branch: not so only when `g` and the staged input differ in it).
__device__ __forceinline__ void stage_out(float* g, const float* s, int n) {
  const int head = head_elems(g, n);
  const int body = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += kThreads) __stcs(g + i, s[i]);
  float4* gv = reinterpret_cast<float4*>(g + head);
  const float* sb = s + head;
  if ((reinterpret_cast<uintptr_t>(sb) & 15) == 0) {
    const float4* sv = reinterpret_cast<const float4*>(sb);
    for (int i = threadIdx.x; i < body; i += kThreads) __stcs(gv + i, sv[i]);
  } else {
    for (int i = threadIdx.x; i < body; i += kThreads) {
      const float* p = sb + 4 * i;
      __stcs(gv + i, make_float4(p[0], p[1], p[2], p[3]));
    }
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads) {
    __stcs(g + i, s[i]);
  }
}

// The domain a template parameter, kItems edges a thread: the same
// steps per edge as var_update_kernel, in the same order, with the
// validity from the edge's bit mask.  At D <= 8 the domain mean is
// always the left-to-right sum (the windowed and lane forms start at
// D = 28).
template <int D, bool kVar, int kItems>
__global__ void __launch_bounds__(kThreads) var_update_tile(const Args a) {
  constexpr int kTile = kThreads * kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int first_flag;
  const int t = threadIdx.x;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int n = min(kTile, a.n_edges - static_cast<int>(e0));
  const float* f2v = a.f2v + e0 * D;
  const float* prev = a.prev + e0 * D;
  float* m = align_like(smem, f2v);
  float* o = align_like(smem + region_bytes(kTile * D * 4), prev);

  // The per-edge bytes and ids first, then the tile's rows as
  // asynchronous copies, then every row gather, before waiting.
  uint8_t bits[kItems];
  int8_t cnt[kItems];
  int ids[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + i * kThreads;
    const bool in = j < n;
    bits[i] = in ? __ldcs(a.edge_valid + e0 + j) : 0;
    cnt[i] = in ? __ldcs(a.count + e0 + j) : 0;
    if constexpr (kVar) ids[i] = in ? __ldcs(a.var_ids + e0 + j) : 0;
  }
  const uint64_t policy = evict_first_policy();
  stage_in(m, f2v, n * D, policy);
  stage_in(o, prev, n * D, policy);
  float bel[kVar ? kItems : 1][D], sum[kVar ? kItems : 1][D];
  if constexpr (kVar) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t row = static_cast<int64_t>(ids[i]) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        sum[i][k] = __ldg(a.sums + row + k);
        bel[i][k] = __ldg(a.beliefs + row + k);
      }
    }
  }
  copies_done();
  const bool first = block_first(a.cycle, &first_flag);

  bool unmatched = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + i * kThreads;
    if (j >= n) continue;
    float* mj = m + j * D;
    const float* oj = o + j * D;
    bool valid[D];
    float cand[D], old[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      valid[k] = (bits[i] >> k) & 1;
      old[k] = oj[k];
    }
    if constexpr (kVar) {
      float acc = valid[0] ? fsub(sum[i][0], mj[0]) : 0.0f;
      int n_valid = valid[0] ? 1 : 0;
#pragma unroll
      for (int k = 1; k < D; ++k) {
        acc = fadd(acc, valid[k] ? fsub(sum[i][k], mj[k]) : 0.0f);
        n_valid += valid[k] ? 1 : 0;
      }
      const float avg = fdiv(acc, static_cast<float>(max(n_valid, 1)));
#pragma unroll
      for (int k = 0; k < D; ++k) {
        cand[k] = valid[k] ? fsub(fsub(bel[i][k], mj[k]), avg) : kBig;
      }
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) cand[k] = ftz(mj[k]);
    }
    bool live = false;
    bool all_ok = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (!first) {
        if (a.mode == 1) {
          cand[k] = fmul(fadd(old[k], cand[k]), 0.5f);
        } else if (a.mode == 2) {
          cand[k] = ffma(a.damping, old[k], fmul(a.one_minus, cand[k]));
        }
      }
      const float delta = fabsf(fsub(cand[k], old[k]));
      const float s = fabsf(fadd(cand[k], old[k]));
      const bool ok = fmul(2.0f, delta) < fmul(a.stability, s) || delta == 0.0f;
      all_ok = all_ok && (ok || !valid[k]);
      live = live || valid[k];
    }
    const bool match = all_ok && !first;
    const bool keep = match && cnt[i] >= kSameCount;
#pragma unroll
    for (int k = 0; k < D; ++k) mj[k] = keep ? old[k] : cand[k];
    __stcs(a.out_count + e0 + j,
           match ? static_cast<int8_t>(min(cnt[i] + 1, kSameCount + 1))
                 : static_cast<int8_t>(1));
    unmatched = unmatched || (live && !match);
  }
  // The barrier before the tile's sent rows are stored.
  if (__syncthreads_or(unmatched) && t == 0) *a.stable = 0;
  stage_out(a.out + e0 * D, m, n * D);
}

template <int D, bool kVar, int kItems>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  constexpr int kTile = kThreads * kItems;
  constexpr int bytes = tile_smem_bytes(D, kItems);
  const auto kernel = var_update_tile<D, kVar, kItems>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(a.n_edges + kTile - 1) / kTile, kThreads, bytes, stream>>>(a);
  return cudaSuccess;
}

template <int D, bool kVar>
cudaError_t launch_items(const Args& a, int items, cudaStream_t stream) {
  switch (items) {
    case 1: return launch_tile<D, kVar, 1>(a, stream);
    case 2: return launch_tile<D, kVar, 2>(a, stream);
    case 4: return launch_tile<D, kVar, 4>(a, stream);
    case 8: return launch_tile<D, kVar, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kVar>
cudaError_t launch(const Args& a, int items, cudaStream_t stream) {
  switch (a.d) {
    case 1: return launch_items<1, kVar>(a, items, stream);
    case 2: return launch_items<2, kVar>(a, items, stream);
    case 3: return launch_items<3, kVar>(a, items, stream);
    case 4: return launch_items<4, kVar>(a, items, stream);
    case 5: return launch_items<5, kVar>(a, items, stream);
    case 6: return launch_items<6, kVar>(a, items, stream);
    case 7: return launch_items<7, kVar>(a, items, stream);
    case 8: return launch_items<8, kVar>(a, items, stream);
    default: {
      const int blocks = (a.n_edges + kThreads - 1) / kThreads;
      var_update_kernel<kVar><<<blocks, kThreads, 0, stream>>>(a);
      return cudaSuccess;
    }
  }
}

}  // namespace

// beliefs/sums null: send_update (f2v holds the candidates).  mode: 0 no
// damping, 1 (o + n) * 0.5, 2 fma(damping, o, one_minus * n).  At
// d <= 8 the kernel reads edge_valid (and var_ids for v2f) and `items`
// (1, 2, 4 or 8) sets the edges a thread; above 8 it reads var_ids and
// var_valid.  Returns a cudaError_t (0 when the launch was taken).
extern "C" int var_update_launch(const float* beliefs, const float* sums,
                                 const float* f2v, const float* prev,
                                 const int8_t* count, const int* var_ids,
                                 const uint8_t* edge_valid,
                                 const uint8_t* var_valid, const int* cycle,
                                 float* out, int8_t* out_count,
                                 uint8_t* stable, int n_edges, int d,
                                 int mode, float damping, float one_minus,
                                 float stability, int var_side, int fused,
                                 int items, cudaStream_t stream) {
  if (n_edges == 0) return 0;
  const bool small = d >= 1 && d <= 8;
  if (d < 1 || mode < 0 || mode > 2 || (var_side && (!beliefs || !sums))
      || (small ? !edge_valid || (var_side && !var_ids)
                : !var_ids || !var_valid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{beliefs, sums,  f2v,       prev,      count,     var_ids,
         edge_valid, var_valid, cycle, out, out_count, stable,
         n_edges, d,     mode,      damping,   one_minus, stability, fused};
  const cudaError_t err = var_side ? launch<true>(a, items, stream)
                                   : launch<false>(a, items, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
