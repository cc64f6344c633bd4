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
// lanes a clock per SM the hash, not memory, bounds both.
//
// uniform: one thread per element; there is nothing to share.
// best_choice: the masked elements are a data-dependent part of each row
// (about 40 % at D = 3 on the local search's masks), so one thread per
// row would leave most lanes idle behind `if (!mask) continue`.  A block
// takes a tile of whole rows instead; each warp, round by round and with
// no block barrier between rounds, reads its lanes' words of the tile's
// mask bytes as coalesced 32-bit words (the tile's first word aligned down,
// bytes outside it dropped), compacts the masked elements into its list
// in shared memory (each lane's count, its prefix from a __ballot_sync
// and __popc per bit of the count), and then every lane of the warp
// hashes list entries, so no lane waits on another's mask.  A draw is
// exactly m * 2^-23 for the top 23 bits m of the hash, so the kernel
// compares the m's and never makes the float.  Each draw goes into its row's slot as one shared atomicMax of
// the key (m << 9 | 511 - j) (64 bits, m << 32 | ~j, above K = 511): on
// equal draws the smaller j is larger, so the maximum is the first index
// of the largest draw, whatever order the lanes come in; an empty row
// keeps 0 and returns slot 0.  K up to 9 is a template constant (the
// division of a list entry into row and slot is then a multiply).

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

constexpr int kChoiceWords = 4;  // mask words a lane reads a round
constexpr int kChoiceSlots = 4 * kChoiceWords;
constexpr int kWarps = kThreads / 32;
// Elements a warp reads a round; a tile holds at most kChoiceTile
// elements (the most rows: kChoiceTile, at K = 1).
constexpr int kChoiceWarpRound = 32 * kChoiceSlots;
constexpr int kChoiceTile = kWarps * kChoiceWarpRound;
// Domains up to this size rank a draw and its slot in one 32-bit key.
constexpr int kSmallKeyMaxK = 511;

// The key of a masked slot j whose draw has mantissa m (the draw is
// exactly m * 2^-23, so m orders the draws as the floats): larger for a
// larger draw, and for a smaller j on equal draws; 0 is no slot.
__device__ __forceinline__ uint32_t choice_key(uint32_t m, int j, uint32_t) {
  return (m << 9) | (511u - static_cast<uint32_t>(j));
}
__device__ __forceinline__ unsigned long long choice_key(
    uint32_t m, int j, unsigned long long) {
  return (static_cast<unsigned long long>(m) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(j));
}
__device__ __forceinline__ int choice_slot(uint32_t key) {
  return key == 0u ? 0 : static_cast<int>(511u - (key & 511u));
}
__device__ __forceinline__ int choice_slot(unsigned long long key) {
  return key == 0ull
      ? 0 : static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// kK: K as a constant (1..9, the common domains and MGM2's pairs), or 0
// for K read at run time.  Key: uint32_t up to K = 511, else 64 bits.
// kSpread: the tile is less than one round (see the round loop).
template <int kK, typename Key, bool kSpread>
__global__ void __launch_bounds__(kThreads)
best_choice_kernel(uint32_t k0, uint32_t k1, const uint8_t* __restrict__ mask,
                   long long n_rows, int k_arg, int rows_per_tile,
                   int* __restrict__ out) {
  // A tile holds at most kChoiceTile / K rows: 8 with 64-bit keys.
  __shared__ Key s_best[sizeof(Key) == 4 ? kChoiceTile
                                         : kChoiceTile / (kSmallKeyMaxK + 1)];
  __shared__ int s_list[kWarps][kChoiceWarpRound];
  const int k = kK > 0 ? kK : k_arg;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_tile;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_tile), n_rows - r0));
  const long long e0 = r0 * k;           // the tile's first element
  const int n_el = rows * k;
  // The tile's bytes as aligned words: byte b of word w is element
  // 4 * w + b - skew of the tile.
  const uintptr_t first = reinterpret_cast<uintptr_t>(mask + e0);
  const int skew = static_cast<int>(first & 3u);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(first - skew);
  const int n_words = (n_el + skew + 3) / 4;
  for (int i = t; i < rows; i += kThreads) s_best[i] = Key(0);
  __syncthreads();
  int* list = s_list[warp];
  // A round reads kChoiceWords words a lane, word w0 + j * kStep + lane:
  // in a full tile each warp's words are contiguous (kStep 32, measured
  // faster on the H100 at the scale graph); a tile of less than one
  // round spreads over all the warps instead (kStep kThreads).  Each
  // warp compacts and hashes its own words with no block barrier between
  // rounds, so one warp's loads overlap another's hashing.
  constexpr int kStep = kSpread ? kThreads : 32;
  for (int w0 = (kSpread ? 32 : 32 * kChoiceWords) * warp; w0 < n_words;
       w0 += kThreads * kChoiceWords) {
    // 1. Read the round's words; bit 4 * j + b: byte b of word j is
    // masked.  A bool byte is 0 or 1, so one multiply gathers a word's
    // four low bits into a nibble; bytes outside the tile are dropped.
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kChoiceWords; ++j) {
      const int w = w0 + j * kStep + lane;
      if (w >= n_words) continue;
      const uint32_t x = __ldcs(words + w);
      unsigned nib = ((x & 0x01010101u) * 0x01020408u) >> 24;
      const int lo = 4 * w - skew;
      if (lo < 0) nib &= 0xFu << (-lo);
      if (lo + 4 > n_el) nib &= 0xFu >> (lo + 4 - n_el);
      bits |= (nib & 0xFu) << (4 * j);
    }
    // 2. Compact into the warp's list: each lane's count, its prefix
    // from a __ballot_sync and __popc per bit of the count.
    const int count = __popc(bits);
    int at = 0;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const unsigned plane = __ballot_sync(0xFFFFFFFFu, (count >> b) & 1);
      at += __popc(plane & lanes_below) << b;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, at + count, 31);
    while (bits != 0u) {
      const int i = __ffs(bits) - 1;
      bits &= bits - 1u;
      list[at++] = 4 * (w0 + (i >> 2) * kStep + lane) + (i & 3) - skew;
    }
    __syncwarp();
    // 3. Every lane hashes masked elements; the row's largest key wins.
    for (int i = lane; i < total; i += 32) {
      const int el = list[i];
      const int row = el / k;
      const unsigned long long e = static_cast<unsigned long long>(e0 + el);
      const uint32_t m = threefry_bits(k0, k1, static_cast<uint32_t>(e >> 32),
                                       static_cast<uint32_t>(e)) >> 9;
      atomicMax(&s_best[row], choice_key(m, el - row * k, Key(0)));
    }
    __syncwarp();  // the list is read before the next round rewrites it
  }
  __syncthreads();
  for (int i = t; i < rows; i += kThreads) {
    out[r0 + i] = choice_slot(s_best[i]);
  }
}

template <int kK, typename Key>
void launch_best_choice(uint32_t k0, uint32_t k1, const uint8_t* mask,
                        long long n_rows, int k, int rows_per_tile,
                        unsigned blocks, int* out, cudaStream_t stream) {
  if (static_cast<long long>(rows_per_tile) * k + 3 < kChoiceTile) {
    best_choice_kernel<kK, Key, true><<<blocks, kThreads, 0, stream>>>(
        k0, k1, mask, n_rows, k, rows_per_tile, out);
  } else {
    best_choice_kernel<kK, Key, false><<<blocks, kThreads, 0, stream>>>(
        k0, k1, mask, n_rows, k, rows_per_tile, out);
  }
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

// rows_per_tile: rows a block takes, 1 .. 4096 / K (at least 1).
extern "C" int threefry_best_choice_launch(uint32_t k0, uint32_t k1,
                                           const uint8_t* mask,
                                           long long n_rows, int k,
                                           int rows_per_tile, int* out,
                                           cudaStream_t stream) {
  if (n_rows < 0 || k < 1 || rows_per_tile < 1 ||
      (rows_per_tile > 1 &&
       static_cast<long long>(rows_per_tile) * k > kChoiceTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const long long blocks = (n_rows + rows_per_tile - 1) / rows_per_tile;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  switch (k) {
#define BEST_CHOICE_K(N)                                                    \
  case N:                                                                   \
    launch_best_choice<N, uint32_t>(k0, k1, mask, n_rows, k, rows_per_tile, \
                                    g, out, stream);                        \
    break;
    BEST_CHOICE_K(1)
    BEST_CHOICE_K(2)
    BEST_CHOICE_K(3)
    BEST_CHOICE_K(4)
    BEST_CHOICE_K(5)
    BEST_CHOICE_K(6)
    BEST_CHOICE_K(7)
    BEST_CHOICE_K(8)
    BEST_CHOICE_K(9)
#undef BEST_CHOICE_K
    default:
      if (k <= kSmallKeyMaxK) {
        launch_best_choice<0, uint32_t>(k0, k1, mask, n_rows, k,
                                        rows_per_tile, g, out, stream);
      } else {
        launch_best_choice<0, unsigned long long>(
            k0, k1, mask, n_rows, k, rows_per_tile, g, out, stream);
      }
  }
  return static_cast<int>(cudaGetLastError());
}
