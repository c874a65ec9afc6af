// Hopper tensor-core building blocks of the flash kernels (flash_fwd_tc.cu,
// flash_fwd_dmma.cu, flash_bwd_tc.cu, flash_bwd_dkv_3xtf32.cu,
// flash_bwd_dq_tc.cu): warp-level mma.sync m16n8k16 with bf16 operands and
// f32 accumulation, mma.sync m16n8k8 with tf32 operands for the f32
// backward bodies (3xTF32: each f32 operand split into two tf32 terms),
// mma.sync m16n8k4 with f64 operands and accumulation for the f32 forward,
// ldmatrix fragment loads from shared memory, cp.async 16-byte copies into
// shared memory, and the staging of strided (T, D) slabs of bf16 or f32
// rows into shared memory and of accumulator blocks back out.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 x b32:  a0 (g, 2t..2t+1)     a1 (g+8, 2t..)
//                                     a2 (g, 2t+8..2t+9)   a3 (g+8, 2t+8..)
//   B (16 x 8, k x n), 2 x b32:       b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g)
//   C (16 x 8, f32), 4 x f32:         c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, ..)
// so the C fragments of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of a 16-deep product: S never leaves the registers.
//
// Fragment layout of mma.m16n8k8 with tf32 operands:
//   A (16 x 8, row major), 4 x b32:  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)
//                                    a3 (g+8, t+4)
//   B (8 x 8, k x n), 2 x b32:       b0 (k t, n g)  b1 (k t+4, n g)
//   C: as m16n8k16.
// Here a C fragment (columns 2t, 2t+1) is NOT an A fragment (columns t,
// t+4): a product's result reaches the next product through shared memory
// or shuffles. Within one product the k index may be permuted freely (the
// same way for A and B), which lets a thread take columns 2t and 2t+1 as
// its k = t and k = t+4 and load both with one 8-byte access.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace t2o {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores (bf16 x bf16 -> f32)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on the tensor cores (tf32 x tf32 -> f32), one k8 step
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on the FP64 tensor cores (f64 in, f64 accumulate), one k4 step
// of mma.sync m16n8k4 (sm_90): A (16 x 4) a0 (g, t) and a1 (g+8, t); B
// (4 x 8) b (k t, n g); C as m16n8k16 (c0, c1 row g, columns 2t, 2t+1;
// c2, c3 row g+8). f32 operands convert to f64 exactly, so the products
// are exact and the sums carry 53 bits.
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// f32 -> tf32 bits, rounded to nearest with ties away from zero: the bits
// of cvt.rna.tf32.f32 for every finite x (add half of the dropped 13 bits'
// range to the magnitude, then clear them; a carry rounds into the
// exponent). Two integer ops; cvt.rna ran the f32 K2 slower on the H100
// at the learner shapes (PERF.md, section 6).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 split: x ~ big + small with big = tf32(x), small = tf32(x - big);
// what small drops is ~2^-22 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b in f32 from split operands (3xTF32): the two cross terms first,
// then big x big; small x small (~2^-22 relative) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// two f32 -> one b32 of two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16-byte global -> shared copy that bypasses L1; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One 16-byte chunk (8 bf16 or 4 f32 from column c) of a strided row,
// gathered with scalar loads; zeros past D and in rows that do not exist.
__device__ __forceinline__ uint4 gather_chunk(const __nv_bfloat16* row,
                                              int64_t s_col, int c, int D,
                                              bool row_ok) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c0 = c + 2 * e;
    __nv_bfloat162 x;
    x.x = row_ok && c0 < D ? row[(int64_t)c0 * s_col]
                           : __float2bfloat16_rn(0.f);
    x.y = row_ok && c0 + 1 < D ? row[(int64_t)(c0 + 1) * s_col]
                               : __float2bfloat16_rn(0.f);
    w[e] = *reinterpret_cast<const uint32_t*>(&x);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 gather_chunk(const float* row, int64_t s_col,
                                              int c, int D, bool row_ok) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = __float_as_uint(
        row_ok && c + e < D ? row[(int64_t)(c + e) * s_col] : 0.f);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage rows [0, n_rows) of a (T, D) slab of bf16 or f32 into shared rows
// of `ld` elements, columns padded with zeros to dp (a multiple of 16),
// rows n_valid..n_rows-1 zero-filled, in 16-byte chunks. With `vec` (D a
// multiple of the chunk, unit column stride, 16-byte aligned rows) each
// chunk is one cp.async (the caller commits and waits); otherwise the chunk
// is gathered with scalar loads and stored at once, inside the same kernel.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t s_row, int64_t s_col,
                                           int n_valid, int n_rows, int D,
                                           int dp, bool vec, int tid,
                                           int nthreads) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = dp / E;
  for (int u = tid; u < n_rows * chunks; u += nthreads) {
    const int r = u / chunks;
    const int c = (u - r * chunks) * E;
    T* d = dst + r * ld + c;
    const bool row_ok = r < n_valid;
    if (vec) {
      const bool ok = row_ok && c < D;
      cp_async_16(d, ok ? src + (int64_t)r * s_row + c : src, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) =
          gather_chunk(src + (int64_t)r * s_row, s_col, c, D, row_ok);
    }
  }
}

// Two neighbouring f32 accumulator values into shared memory as bf16 or f32
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float lo,
                                           float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// A warp's (16 x 8N) f32 accumulator fragments into shared rows of `ld`
// elements at `blk`, rounded to T (the caller syncs the warp before reading
// them).
template <typename T, int N>
__device__ __forceinline__ void stage_frag(T* blk, int ld,
                                           const float (&acc)[N][4], int g,
                                           int t) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    store_pair(blk + g * ld + 8 * n + 2 * t, acc[n][0], acc[n][1]);
    store_pair(blk + (g + 8) * ld + 8 * n + 2 * t, acc[n][2], acc[n][3]);
  }
}

// Write a warp's (16 x w) block, staged at `src` in shared rows of `ld`
// elements, to rows [0, n_rows) and columns [c0, min(c0 + w, D)) of a
// strided output of the same type: 16-byte stores where the output's rows
// allow them (`vec`), strided scalar stores otherwise.
template <typename T>
__device__ __forceinline__ void store_block(T* dst, int64_t s_row,
                                            int64_t s_col, const T* src,
                                            int ld, int n_rows, int c0, int w,
                                            int D, bool vec, int lane) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = w / E;
  for (int u = lane; u < 16 * chunks; u += 32) {
    const int r = u / chunks;
    const int c = c0 + (u - r * chunks) * E;
    if (r >= n_rows || c >= D) continue;
    const T* s = src + r * ld + (c - c0);
    T* d = dst + (int64_t)r * s_row;
    if (vec) {
      *reinterpret_cast<uint4*>(d + c) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < E && c + e < D; ++e)
        d[(int64_t)(c + e) * s_col] = s[e];
    }
  }
}

// Host side: do a bf16 tensor's rows allow 16-byte copies? (D % 8 == 0,
// unit column stride, every other stride a multiple of 8 elements, 16-byte
// aligned base); strides over (B, H, T, D).
inline bool rows_of_8(const void* ptr, const int64_t* s, int D) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && D % 8 == 0 &&
         s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0 && s[3] == 1;
}

// Host side: the padded head widths the tensor-core kernels are built for.
inline int padded_head_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

}  // namespace t2o
