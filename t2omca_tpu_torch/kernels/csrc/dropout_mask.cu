// Dropout's keep mask for Hopper (sm_90a): the kernel and its C entry point.
//
// flax's nn.Dropout keeps an element where
// jax.random.bernoulli(make_rng("dropout"), keep, shape) is true, and
// make_rng folds the scope's path into the stream's key:
// fold_in(key, fold) for a uint32 `fold` computed on the host
// (flax_rng.Scope.fold_data). With the threefry2x32 PRNG and
// jax_threefry_partitionable, element i (row-major) of that draw is, for a
// stream key (k0, k1):
//
//   (f0, f1) = threefry2x32((k0, k1), (0, fold))     the fold_in
//   (b0, b1) = threefry2x32((f0, f1), (0, i))        20 rounds each
//   u        = bitcast_f32(((b0 ^ b1) >> 9) | 0x3F800000) - 1   in [0, 1)
//   keep_i   = u < keep                              (keep as float32)
//
// which is bernoulli(fold_in(key, fold), keep, shape) of prng.py, the plain
// version, bit for bit. Folding here saves the ~160 launches of a fold_in
// on a 2-element key for every mask, which left the eager learner
// host-bound. It replaces no Pallas kernel: the JAX package draws the mask
// with XLA ops (flax/linen/stochastic.py, called from
// t2omca_tpu/models/transformer.py:162 and :172). It was added because the
// plain version runs the hash as ~160 elementwise torch ops, each a pass
// over the whole mask in device memory: at the learner's agent shape
// (2048, 65, 256) one draw took ~19 ms on an H100, ~88% of a dropout
// trainer step (PERF.md).
//
// A data-parallel rank draws its rows of a mask over the global batch: with
// a row map (`rows`, one int64 global row number for each local row of
// `row_elems` elements, read from device memory so a captured graph replays
// it), local element i's counter is rows[i / row_elems] * row_elems +
// i % row_elems, the global element's, so the rank's mask is those rows of
// the whole mask bit for bit. Without a map the kernel is the one it was
// before the map existed (a template parameter selects the path).
//
// What bounds it: operations. Each element costs ~76 32-bit operations (the
// rounds' add, rotate and xor, the key injections, the float compare) and
// one byte written, so the CUDA cores' issue rate, not the bytes, sets the
// floor. The design keeps every round in registers: one thread folds the
// key (one hash, shared by its 4 elements), hashes four consecutive
// counters and writes their four bool bytes as one 32-bit store; a
// rotation is one funnel shift. The key is read from device
// memory, so a captured CUDA graph replays the launch with whatever key the
// static input holds.
//
// The Philox path (dropout_mask_philox_kernel) draws the same mask under
// the rbg and unsafe_rbg PRNG impls, whose keys have 4 words (k0..k3) and
// whose bits are XLA's CPU rng_bit_generator: Philox4x32-10 under the
// Philox key (f0, f1) of the folded key, on the 128-bit counter of words
// (f2, f3, f0, f1) plus the block number, element i being word i % 4 of
// block i / 4 (prng.py). The fold under rbg is threefry_fold on each half,
// (f0, f1) = threefry((k0, k1), (0, fold)) and (f2, f3) likewise from
// (k2, k3); under unsafe_rbg it is an xor with 4 words that depend on
// `fold` alone (the host computes them: prng.unsafe_fold_mask). A thread
// computes one Philox block for its 4 consecutive elements (one block
// when they map to one, as without a row map or with rows of a multiple
// of 4 elements; else a block for each new one) and writes their 4 bool
// bytes as one 32-bit store. Each element costs ~26 32-bit operations (10
// rounds of 2 wide products, 2 three-input xors and the key bumps, a
// quarter each, and the element's select and compare) against threefry's
// ~76: operations still bound it on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The Threefry-2x32 hash of the counter pair (0, lo) under the key (k0, k1)
// → its two output words in y0, y1. uint32 adds wrap modulo 2^32.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t lo, uint32_t& y0,
                                         uint32_t& y1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  y0 = k0;
  y1 = k1 + lo;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y0 += y1;
      y1 = rotl(y1, kRot[i & 1][j]) ^ y0;
    }
    y0 += ks[(i + 1) % 3];
    y1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// The xor of the hash's two words (prng.random_bits).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t lo) {
  uint32_t y0, y1;
  threefry(k0, k1, lo, y0, y1);
  return y0 ^ y1;
}

// prng.uniform's bit trick (23 random mantissa bits under exponent 0,
// minus one: exact) and bernoulli's compare.
__device__ __forceinline__ uint32_t keep_bit(uint32_t bits, float keep) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < keep ? 1u : 0u;
}

// The counters of a thread's kPerThread consecutive elements from `base`:
// base + j, or through the row map (the row index is divided out once and
// then advanced, so a thread whose elements straddle rows reads the next
// row's number).
template <bool kRows>
__device__ __forceinline__ void counters(int64_t base, int64_t n,
                                         const int64_t* __restrict__ rows,
                                         int64_t row_elems,
                                         uint32_t (&ctr)[kPerThread]) {
  if (!kRows) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      ctr[j] = static_cast<uint32_t>(base + j);
    return;
  }
  int64_t row = base / row_elems;
  int64_t col = base - row * row_elems;
  int64_t g = rows[row] * row_elems + col;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    ctr[j] = static_cast<uint32_t>(g);
    ++g;
    if (++col == row_elems && base + j + 1 < n) {
      ++row;
      col = 0;
      g = rows[row] * row_elems;
    }
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    dropout_mask_kernel(const int64_t* __restrict__ key, uint32_t fold,
                        float keep, uint8_t* __restrict__ out, int64_t n,
                        const int64_t* __restrict__ rows,
                        int64_t row_elems) {
  const int64_t base =
      kPerThread * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (base >= n) return;
  uint32_t k0, k1;
  threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
           fold, k0, k1);
  uint32_t ctr[kPerThread];
  counters<kRows>(base, n, rows, row_elems, ctr);
  if (base + kPerThread <= n) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      word |= keep_bit(threefry_bits(k0, k1, ctr[j]), keep) << (8 * j);
    // out is the base of a torch allocation and base a multiple of 4
    *reinterpret_cast<uint32_t*>(out + base) = word;
  } else {
    for (int64_t i = base; i < n; ++i)
      out[i] = static_cast<uint8_t>(
          keep_bit(threefry_bits(k0, k1, ctr[i - base]), keep));
  }
}

// Philox4x32-10 of the counter c under the key (k0, k1), in place.
__device__ __forceinline__ void philox(uint32_t k0, uint32_t k1,
                                       uint32_t (&c)[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kPhiloxM0 * c[0], hi0 = __umulhi(kPhiloxM0, c[0]);
    const uint32_t lo1 = kPhiloxM1 * c[2], hi1 = __umulhi(kPhiloxM1, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
}

// The 4 words of block `blk` of the stream of the folded key f: the
// counter (f2, f3, f0, f1) plus blk, a 128-bit add.
__device__ __forceinline__ void philox_block(const uint32_t (&f)[4],
                                             uint64_t blk,
                                             uint32_t (&w)[4]) {
  const uint64_t lo = (static_cast<uint64_t>(f[3]) << 32 | f[2]);
  const uint64_t s = lo + blk;
  const uint64_t hi = (static_cast<uint64_t>(f[1]) << 32 | f[0]) +
                      (s < lo ? 1u : 0u);
  w[0] = static_cast<uint32_t>(s);
  w[1] = static_cast<uint32_t>(s >> 32);
  w[2] = static_cast<uint32_t>(hi);
  w[3] = static_cast<uint32_t>(hi >> 32);
  philox(f[0], f[1], w);
}

template <bool kRows, bool kXor>
__global__ void __launch_bounds__(kThreads)
    dropout_mask_philox_kernel(const int64_t* __restrict__ key,
                               uint32_t fold, uint4 xor_words, float keep,
                               uint8_t* __restrict__ out, int64_t n,
                               const int64_t* __restrict__ rows,
                               int64_t row_elems) {
  const int64_t base =
      kPerThread * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (base >= n) return;
  uint32_t f[4];
  if (kXor) {
    f[0] = static_cast<uint32_t>(key[0]) ^ xor_words.x;
    f[1] = static_cast<uint32_t>(key[1]) ^ xor_words.y;
    f[2] = static_cast<uint32_t>(key[2]) ^ xor_words.z;
    f[3] = static_cast<uint32_t>(key[3]) ^ xor_words.w;
  } else {
    threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
             fold, f[0], f[1]);
    threefry(static_cast<uint32_t>(key[2]), static_cast<uint32_t>(key[3]),
             fold, f[2], f[3]);
  }
  uint32_t w[4];
  uint64_t have = ~uint64_t(0);
  uint32_t word = 0;
  const int m = base + kPerThread <= n ? kPerThread
                                       : static_cast<int>(n - base);
  for (int j = 0; j < m; ++j) {
    const int64_t i = base + j;
    int64_t g = i;
    if (kRows) {
      const int64_t row = i / row_elems;
      g = rows[row] * row_elems + (i - row * row_elems);
    }
    const uint64_t blk = static_cast<uint64_t>(g) >> 2;
    if (blk != have) {
      philox_block(f, blk, w);
      have = blk;
    }
    // a select chain keeps w in registers (an indexed read would put it
    // in local memory)
    const int q = static_cast<int>(g & 3);
    const uint32_t bits = q == 0 ? w[0] : q == 1 ? w[1] : q == 2 ? w[2] : w[3];
    const uint32_t bit = keep_bit(bits, keep);
    if (m == kPerThread)
      word |= bit << (8 * j);
    else
      out[i] = static_cast<uint8_t>(bit);
  }
  // out is the base of a torch allocation and base a multiple of 4
  if (m == kPerThread) *reinterpret_cast<uint32_t*>(out + base) = word;
}

}  // namespace

extern "C" {

// key: 2 int64 on the device holding uint32 values (the stream's key, before
// the fold); fold: the uint32 folded in; out: n bool bytes, 4-byte aligned.
// n below 2^32 (the draw's counters are 32 bits). rows: null, or n /
// row_elems int64 global row numbers on the device (the whole draw below
// 2^32 elements, checked by the caller). Launches on `stream`; returns a
// cudaError_t code (0 = launched).
int t2o_dropout_mask(const int64_t* key, uint32_t fold, float keep,
                     void* out, int64_t n, const int64_t* rows,
                     int64_t row_elems, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 32) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0 ||
      (rows != nullptr && (row_elems <= 0 || n % row_elems != 0)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (rows == nullptr)
    dropout_mask_kernel<false><<<grid, kThreads, 0, s>>>(key, fold, keep, o,
                                                         n, nullptr, 1);
  else
    dropout_mask_kernel<true><<<grid, kThreads, 0, s>>>(key, fold, keep, o,
                                                        n, rows, row_elems);
  return (int)cudaGetLastError();
}

// The Philox path for a 4-word key (the rbg impls): key 4 int64 on the
// device holding uint32 values; `unsafe` 0 folds `fold` with threefry on
// each half (rbg), 1 xors the key with xor_words (unsafe_rbg). The rest as
// t2o_dropout_mask's.
int t2o_dropout_mask_philox(const int64_t* key, uint32_t fold, int unsafe,
                            const uint32_t* xor_words, float keep,
                            void* out, int64_t n, const int64_t* rows,
                            int64_t row_elems, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 32) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0 ||
      (rows != nullptr && (row_elems <= 0 || n % row_elems != 0)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  const uint4 x = unsafe ? make_uint4(xor_words[0], xor_words[1],
                                      xor_words[2], xor_words[3])
                         : make_uint4(0, 0, 0, 0);
  if (rows == nullptr) {
    if (unsafe)
      dropout_mask_philox_kernel<false, true><<<grid, kThreads, 0, s>>>(
          key, fold, x, keep, o, n, nullptr, 1);
    else
      dropout_mask_philox_kernel<false, false><<<grid, kThreads, 0, s>>>(
          key, fold, x, keep, o, n, nullptr, 1);
  } else {
    if (unsafe)
      dropout_mask_philox_kernel<true, true><<<grid, kThreads, 0, s>>>(
          key, fold, x, keep, o, n, rows, row_elems);
    else
      dropout_mask_philox_kernel<true, false><<<grid, kThreads, 0, s>>>(
          key, fold, x, keep, o, n, rows, row_elems);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
