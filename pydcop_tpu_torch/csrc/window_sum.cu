// Whole-graph float32 totals in XLA:CPU's order, bit for bit.
//
// Replaces the jnp ops `jnp.sum` of the reference's whole-graph totals:
// pydcop_tpu/ops/localsearch.py:139 assignment_cost (the cost of every
// local-search solve), ops/maxsum.py:559 assignment_constraint_cost and
// the variable-side sum of run_maxsum_trace (the cost trace), and
// observability/engine_probe.py's cost and residual.  XLA:CPU sums a
// float32 operand with an axis longer than 32 as a chain of windowed
// reductions (reduce-window: each axis longer than 32 padded with zeros
// to a multiple of 32, half the padding in front, and cut into windows
// of 32, each shorter axis taken whole; each window summed in row-major
// order from +0.0; repeated while an axis is longer than 32), then sums
// what is left in row-major order: left to right, or, where LLVM
// vectorised a direct sum of <= 32 gathered values, in strided lanes
// folded by halves (ops/window_sum.py gather_stages).  CUDA's
// torch.sum and index_add_ follow no fixed order, so no torch call
// gives these bits.
//
// Arithmetic: every add is PTX add.rn.ftz.f32 (inline asm: nvcc
// neither contracts nor reorders it): subnormal operands read as zeros
// of their sign and subnormal results flush, as XLA:CPU's FTZ/DAZ
// does.  Padding slots are added as +0.0, as in the plain version.
//
// Design: one launch a level, one thread a window walking its values
// in order (coalescing is poor: neighbouring lanes read windows 128
// bytes or more apart), then one thread for the last values and the
// head stages.  Bound: the first level reads each value once, N * 4
// bytes over the card's memory rate; the later levels read 1/32 as
// much.  A simple kernel that is right
// first; a tiled version that stages windows through shared memory is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;
constexpr int kThreads = 256;
constexpr int kMaxStages = 2;
constexpr int kMaxLanes = 16;
constexpr int kMaxRowLanes = 8;

__device__ __forceinline__ float fadd(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Box {
  long long n[3];      // input shape
  long long front[3];  // zeros in front on each axis
  long long win[3];    // window shape
  long long out[3];    // output shape
};

// out[w] (w row-major over box.out) = the sum, from +0.0, of window w
// of `in` (shape box.n, row-major) padded with box.front zeros in front
// of each axis (and zeros behind up to out * win), read in row-major
// order.  With lanes > 1 (= box.win[1], at most kMaxRowLanes) each row
// i0 of the window is summed in `lanes` lanes, lane k over the slots
// (i0, k, *) in order (lane 0 from the running sum, the others from
// -0.0), folded by halves into the running sum: the form LLVM gives the
// reference's residual rows.
__global__ void window_level(const float* __restrict__ in, Box box,
                             int lanes, float* __restrict__ out) {
  const long long m = box.out[0] * box.out[1] * box.out[2];
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= m) return;
  const long long w2 = w % box.out[2];
  const long long w1 = (w / box.out[2]) % box.out[1];
  const long long w0 = w / (box.out[2] * box.out[1]);
  float acc = 0.0f;
  for (long long i0 = 0; i0 < box.win[0]; ++i0) {
    const long long a = w0 * box.win[0] + i0 - box.front[0];
    const bool in0 = a >= 0 && a < box.n[0];
    float sums[kMaxRowLanes];
    sums[0] = acc;
    for (int k = 1; k < lanes; ++k) sums[k] = -0.0f;
    for (long long i1 = 0; i1 < box.win[1]; ++i1) {
      const long long b = w1 * box.win[1] + i1 - box.front[1];
      const bool in01 = in0 && b >= 0 && b < box.n[1];
      const float* row = in01 ? in + (a * box.n[1] + b) * box.n[2] : in;
      float& lane = sums[lanes > 1 ? i1 : 0];
      for (long long i2 = 0; i2 < box.win[2]; ++i2) {
        const long long c = w2 * box.win[2] + i2 - box.front[2];
        lane = fadd(lane, (in01 && c >= 0 && c < box.n[2]) ? row[c] : 0.0f);
      }
    }
    for (int half = lanes / 2; half >= 1; half /= 2) {
      for (int k = 0; k < half; ++k) sums[k] = fadd(sums[k], sums[k + half]);
    }
    acc = sums[0];
  }
  out[w] = acc;
}

struct Head {
  int lanes[kMaxStages];
  int end[kMaxStages];
};

// One thread: the <= 32 values of `in` summed in the head's form, from
// +0.0 (a lone value is added to it too).
__global__ void head_sum(const float* __restrict__ in, int n, Head head,
                         float* __restrict__ out) {
  float acc = 0.0f;
  int start = 0;
  for (int s = 0; s < kMaxStages; ++s) {
    const int lanes = head.lanes[s];
    const int end = head.end[s] < n ? head.end[s] : n;
    if (lanes <= 1 || end <= start) continue;
    float sums[kMaxLanes];
    sums[0] = acc;
    for (int k = 1; k < lanes; ++k) sums[k] = 0.0f;
    for (int i = start; i < end; ++i) {
      const int k = (i - start) % lanes;
      sums[k] = fadd(sums[k], in[i]);
    }
    for (int half = lanes / 2; half >= 1; half /= 2) {
      for (int k = 0; k < half; ++k) sums[k] = fadd(sums[k], sums[k + half]);
    }
    acc = sums[0];
    start = end;
  }
  for (int i = start; i < n; ++i) acc = fadd(acc, in[i]);
  *out = acc;
}

}  // namespace

// The sum of every value of x (shape [n0, n1, n2], row-major; more
// than one value, or none) into scratch[last]: scratch holds each
// windowed level's sums one after another, then the total.  While an
// axis is longer than 32, a level cuts each such axis into windows of
// 32 (padded, half the padding in front) and takes each shorter axis
// whole.  row_lanes > 1 sums the rows of the first level's windows in
// lanes over axis 1 (n1 must equal it), and a direct sum (no axis
// longer than 32) as one such window.  (lanes_k, end_k) are the head's
// stages (lanes 1 where unused) of a direct sum in one thread.
extern "C" int window_tree_sum(const float* x, long long n0, long long n1,
                               long long n2, int row_lanes, float* scratch,
                               int lanes0, int end0, int lanes1, int end1,
                               cudaStream_t stream) {
  if (n0 < 0 || n1 < 0 || n2 < 0 || n0 * n1 * n2 == 1 || row_lanes < 1 ||
      row_lanes > kMaxRowLanes || (row_lanes & (row_lanes - 1)) != 0 ||
      (row_lanes > 1 && n1 != row_lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Head head;
  head.lanes[0] = lanes0;
  head.end[0] = end0;
  head.lanes[1] = lanes1;
  head.end[1] = end1;
  for (int s = 0; s < kMaxStages; ++s) {
    const int l = head.lanes[s];
    if (l < 1 || l > kMaxLanes || (l & (l - 1)) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const float* in = x;
  float* out = scratch;
  long long shape[3] = {n0, n1, n2};
  const bool empty = n0 * n1 * n2 == 0;
  if (empty) shape[0] = shape[1] = shape[2] = 0;
  bool direct_lanes = !empty && row_lanes > 1 && n0 <= kWindow &&
                      n1 <= kWindow && n2 <= kWindow;
  while (direct_lanes || shape[0] > kWindow || shape[1] > kWindow ||
         shape[2] > kWindow) {
    Box box;
    for (int k = 0; k < 3; ++k) {
      const long long s = shape[k];
      const long long pad = s > kWindow ? (kWindow - s % kWindow) % kWindow
                                        : 0;
      box.n[k] = s;
      box.front[k] = pad / 2;
      box.win[k] = s > kWindow ? kWindow : s;
      box.out[k] = (s + pad) / box.win[k];
    }
    const long long m = box.out[0] * box.out[1] * box.out[2];
    const long long blocks = (m + kThreads - 1) / kThreads;
    window_level<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        in, box, in == x ? row_lanes : 1, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = out;
    out += m;
    for (int k = 0; k < 3; ++k) shape[k] = box.out[k];
    head.lanes[0] = head.lanes[1] = 1;
    direct_lanes = false;
  }
  head_sum<<<1, 1, 0, stream>>>(in, static_cast<int>(shape[0] * shape[1] *
                                                     shape[2]),
                                head, out);
  return static_cast<int>(cudaGetLastError());
}
