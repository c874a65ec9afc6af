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
// What bounds it: operations. Each element costs ~76 32-bit operations (the
// rounds' add, rotate and xor, the key injections, the float compare) and
// one byte written, so the CUDA cores' issue rate, not the bytes, sets the
// floor. The design keeps every round in registers: one thread folds the
// key (one hash, shared by its 4 elements), hashes four consecutive
// counters and writes their four bool bytes as one 32-bit store; a
// rotation is one funnel shift. The key is read from device
// memory, so a captured CUDA graph replays the launch with whatever key the
// static input holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
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

__global__ void __launch_bounds__(kThreads)
    dropout_mask_kernel(const int64_t* __restrict__ key, uint32_t fold,
                        float keep, uint8_t* __restrict__ out, int64_t n) {
  const int64_t base =
      kPerThread * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (base >= n) return;
  uint32_t k0, k1;
  threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
           fold, k0, k1);
  if (base + kPerThread <= n) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      word |= keep_bit(threefry_bits(k0, k1, static_cast<uint32_t>(base + j)),
                       keep)
              << (8 * j);
    // out is the base of a torch allocation and base a multiple of 4
    *reinterpret_cast<uint32_t*>(out + base) = word;
  } else {
    for (int64_t i = base; i < n; ++i)
      out[i] = static_cast<uint8_t>(
          keep_bit(threefry_bits(k0, k1, static_cast<uint32_t>(i)), keep));
  }
}

}  // namespace

extern "C" {

// key: 2 int64 on the device holding uint32 values (the stream's key, before
// the fold); fold: the uint32 folded in; out: n bool bytes, 4-byte aligned.
// n below 2^32 (the draw's counters are 32 bits). Launches on `stream`;
// returns a cudaError_t code (0 = launched).
int t2o_dropout_mask(const int64_t* key, uint32_t fold, float keep,
                     void* out, int64_t n, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 32) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads);
  dropout_mask_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      key, fold, keep, static_cast<uint8_t*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
