// Whole-graph float32 totals in XLA:CPU's order, bit for bit, one launch
// a total.
//
// Replaces the jnp ops `jnp.sum` of the reference's whole-graph totals
// and the gathers that feed them: pydcop_tpu/ops/localsearch.py:139
// assignment_cost (the cost of every local-search solve),
// ops/maxsum.py:559 assignment_constraint_cost and the variable-side sum
// of run_maxsum_trace (the cost trace), and
// observability/engine_probe.py's cost and residual.  A total is a chain
// of operands, each summed as XLA:CPU sums it, the sums added in source
// order with XLA's flushing add.  An operand is either a cost gather
// (factor f's entry table[f, sum_p values[ids[f, p]] * D^(arity-1-p)],
// or table[f, values[f]] for the variable costs) or a plain float32
// array of at most three axes.
//
// XLA:CPU sums an operand with an axis longer than 32 as a chain of
// windowed reductions (each axis longer than 32 padded with zeros to a
// multiple of 32, half the padding in front, cut into windows of 32,
// each shorter axis taken whole; each window box summed in row-major
// order from +0.0; again while an axis is longer than 32), then sums what
// is left left to right from +0.0.  Where LLVM vectorised a sum the
// order differs, and the host hands each operand its form, computed by
// ops/window_sum.py (gather_stages, residual_lanes, residual_rows):
//   - head stages for a direct sum of <= 32 gathered values: stage s
//     sums slots [previous end, end_s) in lanes_s strided lanes (lane 0
//     from the running sum, the others from +0.0) folded by halves;
//   - row lanes over axis 1 at the first level (lane k sums the row's
//     axis-1 slots k, k + lanes1, ... in order, each over axis 2, lane 0
//     from the running sum, the others from -0.0, folded into the
//     running sum row by row);
//   - rows in lanes over axis 0 at the first level (the box's rows
//     [0, end0) in lanes0 lanes, row r into lane r % lanes0, each row's
//     values in order, lane 0 from +0.0, the others from -0.0, folded by
//     halves; then the other rows in order).
// A one-value operand is a copy (no add, no flush).  The chain starts
// from the first operand's sum (XLA drops the reference's `0.0 +`), or
// from +0.0 where the port adds into zeros (from_zero).
// CUDA's torch.sum and index_add_ follow no fixed order, so no torch
// call gives these bits.
//
// Arithmetic: every add is add.rn.ftz.f32 (__fadd_rn under -ftz=true:
// never contracted into an FMA): subnormal operands read as zeros of
// their sign and subnormal results flush, as XLA:CPU's FTZ/DAZ does.  Padding
// slots are added as +0.0, as in the plain version.  No float atomics:
// the result does not depend on the order in which blocks finish.
//
// Design: one launch computes the whole total.  The work is cut into
// items of one warp each.  An operand whose only long axis is axis 0
// takes one item per second-level window (up to 32 x 32 first-level
// windows): the warp stages the window's values (gathered in place: the
// [F] vector of costs is never written) through shared memory with
// coalesced loads, each lane sums one first-level window in order from
// rows padded to 33 floats (no bank conflicts), and the warp adds the 32
// window sums in order into one partial in scratch.  Another long axis
// (the residual at D > 32) takes one item per 32 first-level boxes, a
// lane a box.  A short operand takes one item.  Each block then takes a
// ticket (__threadfence, then atomicAdd on a per-device counter); the
// last block to arrive runs, in fixed order, each operand's remaining
// levels (a vector's in shared memory, read in with every thread), then
// the chain, writes the total into the caller's slot and resets the
// counter.  The descriptor (built once per operand set by the wrapper)
// is the kernel's parameter block; each block copies its used part to
// shared memory first.  Every device function is inlined: on this
// one-wave kernel a call's register spills cost microseconds.  Bound:
// each value (or, for a gather, its ids, their values and one table
// entry, each a 32-byte sector at random) is read once; the later levels
// read 1/1024 as much.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWindow * kWarps;
constexpr int kMaxOperands = 16;
constexpr int kMaxStages = 2;
constexpr int kMaxLanes = 16;
constexpr unsigned kFull = 0xffffffffu;

// Operand paths (ops/window_sum.py _layout).
constexpr int kDirect = 0;   // no axis longer than 32: one item
constexpr int kRows = 1;     // only axis 0 longer than 32
constexpr int kGeneral = 2;  // axis 1 or 2 longer than 32

// Mirrored field for field by ops/window_sum.py _Operand (ctypes).
struct Operand {
  const float* x;    // plain values, or the gather's cost table
  const int* ids;    // gather: [F, arity] variable ids; null: f reads values[f]
  long long n[3];    // shape ([F, 1, 1] for a gather)
  long long row;     // gather: table row length (D^arity, or D)
  long long item0;   // first work item of the operand
  long long items;   // its work items
  long long part;    // scratch offset of its items' results
  long long fin;     // scratch offset of its finishing levels
  int gather;
  int arity;
  int d;
  int lanes1;        // row lanes over axis 1 at the first level (1: none)
  int lanes0;        // rows in lanes over axis 0 at the first level
  int end0;          // ... over the box's rows [0, end0)
  int head_lanes[kMaxStages];
  int head_end[kMaxStages];
  int path;
  int unused;
};

struct Desc {
  int n_ops;
  int from_zero;     // the chain starts from +0.0
  long long n_values;
  long long n_items;
  Operand op[kMaxOperands];
};

// add.rn.ftz.f32: the intrinsic is never contracted into an FMA, and
// -ftz=true flushes its operands and result; unlike inline asm it lets
// the compiler issue the loads that feed a chain of adds ahead of them.
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}

// Where a sum reads its values: an operand (plain, or gathered at the
// assignment) or the scratch written earlier in this launch.
struct Src {
  const float* x;
  const int* ids;
  const int* values;
  long long n_values;
  long long row;
  int kind;  // kPlainSrc, kVarSrc (row f at values[f]), kIdsSrc, kScratchSrc
  int arity;
  int d;
};
constexpr int kPlainSrc = 0;
constexpr int kVarSrc = 1;
constexpr int kIdsSrc = 2;
constexpr int kScratchSrc = 3;

__device__ __forceinline__ int value_at(const Src& s, long long id) {
  // Ids past the values read 0 (the sentinel row of a padded bucket).
  return id < s.n_values ? __ldg(s.values + id) : 0;
}

// Factor i's cost at the assignment: its table entry at the flat index
// of its variables' values.
__device__ __forceinline__ float gather_ids(const Src& s, long long i) {
  long long flat = 0;
  const int* r = s.ids + i * s.arity;
  for (int p = 0; p < s.arity; ++p) {
    flat = flat * s.d + value_at(s, __ldg(r + p));
  }
  return __ldg(s.x + i * s.row + flat);
}

// Value i (row-major) of the source.
__device__ __forceinline__ float read(const Src& s, long long i) {
  switch (s.kind) {
    case kPlainSrc:
      return __ldg(s.x + i);
    case kVarSrc:
      return __ldg(s.x + i * s.row + value_at(s, i));
    case kIdsSrc:
      return gather_ids(s, i);
    default:
      return __ldcg(s.x + i);
  }
}

__device__ Src source_of(const Operand& o, const int* values,
                         long long n_values) {
  Src s;
  s.x = o.x;
  s.ids = o.ids;
  s.values = values;
  s.n_values = n_values;
  s.row = o.row;
  s.arity = o.arity;
  s.d = o.d;
  s.kind = !o.gather ? kPlainSrc : o.ids == nullptr ? kVarSrc : kIdsSrc;
  return s;
}

__device__ __forceinline__ Src scratch_source(const float* in) {
  Src s;
  s.x = in;
  s.ids = nullptr;
  s.values = nullptr;
  s.n_values = 0;
  s.row = 0;
  s.kind = kScratchSrc;
  s.arity = 0;
  s.d = 0;
  return s;
}

struct Geometry {
  long long front[3];
  long long win[3];
  long long out[3];
};

// One windowed level over shape n: each axis longer than 32 padded to a
// multiple of 32 (half the padding in front) and cut into windows of 32,
// each shorter axis taken whole.
__device__ Geometry level_geometry(const long long n[3]) {
  Geometry g;
  for (int k = 0; k < 3; ++k) {
    const long long s = n[k];
    const long long pad = s > kWindow ? (kWindow - s % kWindow) % kWindow : 0;
    g.front[k] = pad / 2;
    g.win[k] = s > kWindow ? kWindow : s;
    g.out[k] = s > kWindow ? (s + pad) / kWindow : 1;
  }
  return g;
}

__device__ __forceinline__ long long numel(const long long n[3]) {
  return n[0] * n[1] * n[2];
}

__device__ __forceinline__ void fold(float* s, int lanes) {
  for (int half = lanes / 2; half >= 1; half /= 2) {
    for (int k = 0; k < half; ++k) s[k] = fadd(s[k], s[k + half]);
  }
}

// The sum from +0.0 of the box of shape win at origin (a0, b0, c0) of an
// array of shape n read from src (row-major; slots outside the array are
// +0.0), in row-major order, with row lanes over axis 1 (lanes1 > 1
// dividing win[1], slot i1 into lane i1 % lanes1) or rows in lanes over
// axis 0 (lanes0 > 1, over the
// box's rows [0, end0)): the residual's and the long inner axes' path,
// one thread a box.
__device__ __forceinline__ float box_sum(const Src& src, const long long* n,
                                      long long a0, long long b0,
                                      long long c0, const long long* win,
                                      int lanes1, int lanes0, int end0) {
  float acc = 0.0f;
  long long first = 0;
  float s[kMaxLanes];
  if (lanes0 > 1) {
    s[0] = acc;
    for (int k = 1; k < lanes0; ++k) s[k] = -0.0f;
    first = end0;
  }
  for (long long i0 = 0; i0 < win[0]; ++i0) {
    const long long a = a0 + i0;
    const bool lane_rows = i0 < first;
    if (i0 == first && first > 0) {
      fold(s, lanes0);
      acc = s[0];
    }
    float rsum = lane_rows ? s[i0 % lanes0] : 0.0f;
    if (!lane_rows && lanes1 > 1) {
      s[0] = acc;
      for (int k = 1; k < lanes1; ++k) s[k] = -0.0f;
    }
    for (long long i1 = 0; i1 < win[1]; ++i1) {
      const long long b = b0 + i1;
      float lane = lane_rows ? rsum : lanes1 > 1 ? s[i1 % lanes1] : acc;
      for (long long i2 = 0; i2 < win[2]; ++i2) {
        const long long c = c0 + i2;
        const bool in = a >= 0 && a < n[0] && b >= 0 && b < n[1] &&
                        c >= 0 && c < n[2];
        lane = fadd(lane, in ? read(src, (a * n[1] + b) * n[2] + c) : 0.0f);
      }
      if (lane_rows) {
        rsum = lane;
      } else if (lanes1 > 1) {
        s[i1 % lanes1] = lane;
      } else {
        acc = lane;
      }
    }
    if (lane_rows) {
      s[i0 % lanes0] = rsum;
    } else if (lanes1 > 1) {
      fold(s, lanes1);
      acc = s[0];
    }
  }
  if (first > 0 && first >= win[0]) {
    fold(s, lanes0);
    acc = s[0];
  }
  return acc;
}

// The direct sum of the n values v (left to right from +0.0, the head's
// stages first).
__device__ __forceinline__ float head_sum(const float* v, int n,
                                       const Operand& o) {
  float acc = 0.0f;
  int start = 0;
  for (int s = 0; s < kMaxStages; ++s) {
    const int lanes = o.head_lanes[s];
    const int end = o.head_end[s] < n ? o.head_end[s] : n;
    if (lanes <= 1 || end <= start) continue;
    float sums[kMaxLanes];
    sums[0] = acc;
    for (int k = 1; k < lanes; ++k) sums[k] = 0.0f;
    for (int i = start; i < end; ++i) {
      const int k = (i - start) % lanes;
      sums[k] = fadd(sums[k], v[i]);
    }
    fold(sums, lanes);
    acc = sums[0];
    start = end;
  }
  for (int i = start; i < n; ++i) acc = fadd(acc, v[i]);
  return acc;
}

// v[q] = value base + 32 q + lane of src (+0.0 outside [0, n)) for q <
// kHalf: the loads of a lane issued before any is used; for a gather,
// each dependent step (its ids, their values, the table entry) for the
// kHalf slots at once (a binary factor's two ids in one step).  Half a
// window at a time keeps the arrays in registers.
constexpr int kHalf = kWindow / 2;

template <int Kind>
__device__ __forceinline__ void stage_half(float* v, const Src& src,
                                           long long base, int lane,
                                           long long n) {
  if (Kind == kPlainSrc) {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const long long i = base + q * kWindow + lane;
      v[q] = (i >= 0 && i < n) ? __ldg(src.x + i) : 0.0f;
    }
    return;
  }
  int flat[kHalf];
  if (Kind == kVarSrc) {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const long long i = base + q * kWindow + lane;
      flat[q] = (i >= 0 && i < n) ? value_at(src, i) : 0;
    }
  } else if (src.arity <= 2) {
    int id0[kHalf], id1[kHalf];
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const long long i = base + q * kWindow + lane;
      const bool in = i >= 0 && i < n;
      const int* r = src.ids + i * src.arity;
      id0[q] = in ? __ldg(r) : -1;
      id1[q] = in && src.arity == 2 ? __ldg(r + 1) : -1;
    }
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const int v0 = id0[q] >= 0 ? value_at(src, id0[q]) : 0;
      const int v1 = id1[q] >= 0 ? value_at(src, id1[q]) : 0;
      flat[q] = src.arity == 2 ? v0 * src.d + v1 : v0;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) flat[q] = 0;
    for (int p = 0; p < src.arity; ++p) {
      int id[kHalf];
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const long long i = base + q * kWindow + lane;
        id[q] = (i >= 0 && i < n) ? __ldg(src.ids + i * src.arity + p) : -1;
      }
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        flat[q] = flat[q] * src.d + (id[q] >= 0 ? value_at(src, id[q]) : 0);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const long long i = base + q * kWindow + lane;
    v[q] = (i >= 0 && i < n) ? __ldg(src.x + i * src.row + flat[q]) : 0.0f;
  }
}

// v[q] = value base + 32 q + lane of src for the 32 q: a plain operand's
// 32 loads at once, a gather's half by half.
template <int Kind>
__device__ __forceinline__ void stage_loads(float* v, const Src& src,
                                            long long base, int lane,
                                            long long n) {
  if (Kind == kPlainSrc) {
#pragma unroll
    for (int q = 0; q < kWindow; ++q) {
      const long long i = base + q * kWindow + lane;
      v[q] = (i >= 0 && i < n) ? __ldg(src.x + i) : 0.0f;
    }
    return;
  }
  stage_half<Kind>(v, src, base, lane, n);
  stage_half<Kind>(v + kHalf, src, base + kHalf * kWindow, lane, n);
}

// The sum, in order from +0.0, of the first `count` of the warp's 32
// lane values.
__device__ __forceinline__ float warp_ordered_sum(float x, int count) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kWindow; ++t) {
    const float y = __shfl_sync(kFull, x, t);
    if (t < count) acc = fadd(acc, y);
  }
  return acc;
}

// One work item: a warp of the block, item `j` of operand o.
__device__ __forceinline__ void run_item(const Operand& o, const Src& src,
                                      float* scratch, long long j, int lane,
                                      float (*stage)[kWindow + 1]) {
  if (o.path == kDirect) {
    const long long total = numel(o.n);
    float result = 0.0f;
    if (total == 1) {
      if (lane == 0) result = read(src, 0);  // a copy: no add, no flush
    } else if (total <= kWindow && o.lanes1 <= 1 && o.lanes0 <= 1) {
      // Read the <= 32 values together, then one lane sums them.
      float* v = stage[0];
      if (lane < total) v[lane] = read(src, lane);
      __syncwarp();
      if (lane == 0) result = head_sum(v, static_cast<int>(total), o);
      __syncwarp();
    } else if (lane == 0) {
      const long long zero[3] = {0, 0, 0};
      result = box_sum(src, o.n, zero[0], zero[1], zero[2], o.n, o.lanes1,
                       o.lanes0, o.end0);
      if (o.lanes1 > 1 || o.lanes0 > 1) result = fadd(0.0f, result);
    }
    if (lane == 0) scratch[o.part] = result;
    return;
  }
  const Geometry g1 = level_geometry(o.n);
  if (o.path == kGeneral) {
    // Lane t: the first-level box 32 j + t, into the finishing area.
    const long long m1 = numel(g1.out);
    const long long w = j * kWindow + lane;
    if (w < m1) {
      const long long w2 = w % g1.out[2];
      const long long w1 = (w / g1.out[2]) % g1.out[1];
      const long long w0 = w / (g1.out[2] * g1.out[1]);
      scratch[o.fin + w] = box_sum(
          src, o.n, w0 * g1.win[0] - g1.front[0],
          w1 * g1.win[1] - g1.front[1], w2 * g1.win[2] - g1.front[2],
          g1.win, o.lanes1, o.lanes0, o.end0);
    }
    return;
  }
  // kRows: item j is second-level window j over the first-level windows
  // (or, with at most 32 of them, all of them and the operand's total).
  const long long m1 = g1.out[0];
  const bool two = m1 > kWindow;
  const long long p2 = two ? ((kWindow - m1 % kWindow) % kWindow) / 2 : 0;
  const long long w = j * kWindow - p2 + lane;  // this lane's window
  float sum;
  if (o.n[1] * o.n[2] == 1 && o.lanes1 <= 1 && o.lanes0 <= 1) {
    // Stage the 32 x 32 values with coalesced loads, all in flight at
    // once, a row a window; each lane sums its row.
    const long long base = (j * kWindow - p2) * kWindow - g1.front[0];
    float v[kWindow];
    if (src.kind == kPlainSrc) {
      stage_loads<kPlainSrc>(v, src, base, lane, o.n[0]);
    } else if (src.kind == kVarSrc) {
      stage_loads<kVarSrc>(v, src, base, lane, o.n[0]);
    } else {
      stage_loads<kIdsSrc>(v, src, base, lane, o.n[0]);
    }
#pragma unroll
    for (int q = 0; q < kWindow; ++q) stage[q][lane] = v[q];
    __syncwarp();
    sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kWindow; ++s) sum = fadd(sum, stage[lane][s]);
    __syncwarp();
  } else {
    sum = (w >= 0 && w < m1)
              ? box_sum(src, o.n, w * kWindow - g1.front[0], 0, 0, g1.win,
                        o.lanes1, o.lanes0, o.end0)
              : 0.0f;
  }
  // The warp adds its windows in order from +0.0: the second-level sum,
  // or the operand's last, direct sum over its m1 <= 32 windows.
  const float acc = warp_ordered_sum(sum, two ? kWindow
                                              : static_cast<int>(m1));
  if (lane == 0) scratch[o.part + j] = acc;
}

// Whole windowed levels of the m values in buf (shared memory, room
// for the outputs after them) while more than 32 are left, by the whole
// block; returns where the last level's values start, *m their count.
__device__ float* shared_levels(float* buf, long long* m) {
  float* in = buf;
  int len = static_cast<int>(*m);
  while (len > kWindow) {
    const int pad = (kWindow - len % kWindow) % kWindow;
    const int front = pad / 2;
    const int out_len = (len + pad) / kWindow;
    float* out = in + len;
    for (int w = threadIdx.x; w < out_len; w += blockDim.x) {
      float acc = 0.0f;
      const int base = w * kWindow - front;
#pragma unroll
      for (int s = 0; s < kWindow; ++s) {
        const int i = base + s;
        acc = fadd(acc, (i >= 0 && i < len) ? in[i] : 0.0f);
      }
      out[w] = acc;
    }
    __syncthreads();
    in = out;
    len = out_len;
  }
  *m = len;
  return in;
}

// buf[0, m) = in[0, m) (scratch) by the whole block, each thread's loads
// issued together.
__device__ __forceinline__ void copy_to_shared(float* buf, const float* in,
                                               long long m) {
  constexpr int kEach = 8;
  for (long long first = 0; first < m; first += kEach * blockDim.x) {
    float t[kEach];
#pragma unroll
    for (int c = 0; c < kEach; ++c) {
      const long long i = first + c * blockDim.x + threadIdx.x;
      t[c] = i < m ? __ldcg(in + i) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kEach; ++c) {
      const long long i = first + c * blockDim.x + threadIdx.x;
      if (i < m) buf[i] = t[c];
    }
  }
}

// In the last block: operand o's remaining levels and its total.
__device__ __forceinline__ float finish(const Operand& o, float* scratch,
                                     float* buf, long long buf_floats) {
  const Geometry g1 = level_geometry(o.n);
  const bool rows_one = o.path == kRows && g1.out[0] <= kWindow;
  if (o.path == kDirect || rows_one) return __ldcg(scratch + o.part);
  long long shape[3];
  const float* in;
  float* out = scratch + o.fin;
  if (o.path == kRows) {
    const long long m1 = g1.out[0];
    shape[0] = (m1 + (kWindow - m1 % kWindow) % kWindow) / kWindow;
    shape[1] = shape[2] = 1;
    in = scratch + o.part;
  } else {
    for (int k = 0; k < 3; ++k) shape[k] = g1.out[k];
    in = scratch + o.fin;
    out += numel(shape);
  }
  long long m = numel(shape);
  const float* last;
  if (shape[1] == 1 && shape[2] == 1 && m + m / 16 + kWindow <= buf_floats) {
    // A vector that fits: read it into shared memory with every thread,
    // then its levels there.
    copy_to_shared(buf, in, m);
    __syncthreads();
    last = shared_levels(buf, &m);
  } else {
    // Levels in scratch, a thread a box.
    Src src = scratch_source(in);
    while (shape[0] > kWindow || shape[1] > kWindow || shape[2] > kWindow) {
      const Geometry g = level_geometry(shape);
      const long long mo = numel(g.out);
      for (long long w = threadIdx.x; w < mo; w += blockDim.x) {
        const long long w2 = w % g.out[2];
        const long long w1 = (w / g.out[2]) % g.out[1];
        const long long w0 = w / (g.out[2] * g.out[1]);
        out[w] = box_sum(src, shape, w0 * g.win[0] - g.front[0],
                         w1 * g.win[1] - g.front[1],
                         w2 * g.win[2] - g.front[2], g.win, 1, 1, 0);
      }
      __syncthreads();
      src = scratch_source(out);
      out += mo;
      for (int k = 0; k < 3; ++k) shape[k] = g.out[k];
    }
    m = numel(shape);
    if (m <= buf_floats) {
      for (long long i = threadIdx.x; i < m; i += blockDim.x) {
        buf[i] = __ldcg(src.x + i);
      }
      __syncthreads();
      last = buf;
    } else {
      last = src.x;
    }
  }
  // What is left (<= 32 values, or a box of short axes), left to right
  // from +0.0.
  float acc = 0.0f;
  if (threadIdx.x == 0) {
    for (long long i = 0; i < m; ++i) acc = fadd(acc, last[i]);
  }
  __syncthreads();
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    window_total(const __grid_constant__ Desc desc, const int* values,
                 float* scratch, unsigned int* ticket, float* out) {
  __shared__ float stage[kWarps][kWindow][kWindow + 1];
  __shared__ float s_total[kMaxOperands];
  __shared__ bool s_last;
  // The descriptor's used part into shared memory first, with every
  // thread: reads of the parameter block by computed address are slow.
  __shared__ Desc s_desc;
  {
    const int* from = reinterpret_cast<const int*>(&desc);
    int* to = reinterpret_cast<int*>(&s_desc);
    const int words = static_cast<int>(
        (sizeof(Desc) - sizeof(Operand) * (kMaxOperands - desc.n_ops)) / 4);
    for (int i = threadIdx.x; i < words; i += blockDim.x) to[i] = from[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / kWindow;
  const int lane = threadIdx.x % kWindow;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item < s_desc.n_items) {
    int k = 0;
    while (item >= s_desc.op[k].item0 + s_desc.op[k].items) ++k;
    const Operand o = s_desc.op[k];
    const Src src = source_of(o, values, s_desc.n_values);
    run_item(o, src, scratch, item - o.item0, lane, stage[warp]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* buf = &stage[0][0][0];
  const int n_ops = s_desc.n_ops;
  for (int k = 0; k < n_ops; ++k) {
    const Operand o = s_desc.op[k];
    const float t = finish(o, scratch, buf,
                           kWarps * kWindow * (kWindow + 1));
    if (threadIdx.x == 0) s_total[k] = t;
  }
  if (threadIdx.x == 0) {
    float total = 0.0f;
    if (n_ops > 0) {
      total = s_desc.from_zero ? fadd(0.0f, s_total[0]) : s_total[0];
      for (int k = 1; k < n_ops; ++k) total = fadd(total, s_total[k]);
    }
    *out = total;
    *ticket = 0u;
  }
}

}  // namespace

// The size in bytes of the descriptor this library takes (the wrapper
// checks its own against it).
extern "C" int window_total_desc_bytes() {
  return static_cast<int>(sizeof(Desc));
}

// Launches the total of `desc` (a host copy, passed as the kernel's
// parameter block) on `stream`: `values` the assignment (int32),
// `scratch` at least the floats the wrapper sized,
// `ticket` a zeroed per-device counter, `out` the float to write.
extern "C" int window_total_launch(const void* desc_bytes,
                                   const void* values, float* scratch,
                                   unsigned int* ticket, float* out,
                                   cudaStream_t stream) {
  // Passed as bytes: a parameter of an unnamed namespace's type would
  // give the function internal linkage.
  const Desc* desc = static_cast<const Desc*>(desc_bytes);
  if (desc->n_ops < 0 || desc->n_ops > kMaxOperands || desc->n_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < desc->n_ops; ++k) {
    const Operand& o = desc->op[k];
    if (o.lanes1 < 1 || o.lanes1 > kMaxLanes || o.lanes0 < 1 ||
        o.lanes0 > kMaxLanes || o.end0 < 0 || o.path < kDirect ||
        o.path > kGeneral) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int s = 0; s < kMaxStages; ++s) {
      if (o.head_lanes[s] < 1 || o.head_lanes[s] > kMaxLanes) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  long long blocks = (desc->n_items + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_total<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      *desc, static_cast<const int*>(values), scratch, ticket, out);
  return static_cast<int>(cudaGetLastError());
}
