// Flash-attention forward, bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces, for bf16 inputs, the TPU kernel `_flash_attention_kernel`
// (t2omca_tpu/kernels/attention.py:115) in both of its launches: K1 at
// :392 (the serve path and the learner's target unrolls) and K1 +
// residuals at :383 (the learner's online unrolls; also writes each row's
// final running max m and denominator l). The f32 forward is the FP64
// tensor-core body of flash_fwd_dmma.cu; t2o_flash_fwd (flash_fwd.cu)
// validates the arguments and calls this file for bf16. The function and
// its semantics are those of flash_fwd.cu's header: a nonzero bias
// REPLACES the logit, causal columns take -1e9, the running max starts
// at -1e30 and key-tail padding never enters a row (an all-masked row is
// the uniform mean of the real values, m = -1e9, l = Tk).
//
// Bound on this card: bytes. At every main-path shape (serve (4096, 4, 65,
// 65, 64); learner agent (2048, 1, 4, 65, 256) and mixer (32, 1, 268, 131,
// 256)) the products are at most 1/6 of the byte time at the bf16
// tensor-core peak, but on the CUDA cores in f32 they cost as much as the
// whole byte time. So the design puts every product on the tensor cores and
// keeps the memory system busy:
//
// * mma.sync m16n8k16 (bf16 in, f32 accumulate), not wgmma: wgmma's 64-row
//   granule would waste 94% of its rows at Tq = 4 and half at Tq = 65, and
//   at these shapes the tensor-core peak is not the limit. One warp owns 16
//   query rows; at D = 256 two warps share them, each owning 128 output
//   columns (an f32 16 x 256 accumulator would cost 128 registers a thread)
//   and each computing the full S itself.
// * Operands stay bf16 in shared memory, fed to the tensor cores by
//   ldmatrix (.trans for V). Shared rows are padded by 16 bytes, so the 8
//   row addresses of each ldmatrix phase fall in distinct banks.
// * Online softmax on the S fragment in registers (FlashAttention-2): row
//   max and sum over the 4 lanes of a quad, P rounded to bf16 in registers
//   and fed as the A operand of P V. S and P never touch shared memory and
//   no barrier separates logits, softmax and P V. Running max, denominator
//   and accumulator stay f32; P's bf16 rounding is the only new rounding.
// * K and V tiles of 16 keys come in by cp.async 16-byte copies (zero-filled
//   past Tk and past D) into a two-stage ring, so tile j + 1 loads while
//   tile j computes; Q is loaded once. Rows that are not 16-byte aligned
//   (D % 8 != 0, odd strides) are gathered with scalar loads in the same
//   kernel, zero-padded to a multiple of 16 columns, and still run on the
//   tensor cores. When k and v are one tensor (the query-slice call) the
//   tile is staged once.
// * Grid: one CTA per (b, h, q tile) of up to 128 rows (64 at D = 256):
//   the serve shape is one CTA of 5 warps (the 65th row takes a fifth
//   16-row tile, 15 rows of which are padding) and ~21 KB of shared memory
//   per (b, h), the agent shape one CTA of 2 warps per b, the mixer shape
//   160 CTAs of 8 warps. Of the variants timed on the H100 (PERF.md), 16-key
//   tiles with Q reloaded from shared memory and a register cap that packs
//   five serve CTAs per SM ran fastest without spilling; a deeper ring that
//   loads all of the serve shape's keys at once ran slower.
// * The output is staged through the (finished) Q tile in shared memory and
//   leaves in 16-byte stores.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2o;
using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 8;

struct TcParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;   // nullptr = no mask; else (B, H, Tq, Tk) by strides
  bf16* o;
  float* m;            // nullptr = no residuals; else (B, H, Tq) contiguous
  float* l;
  int B, H, Tq, Tk, D;
  int64_t sq[4], sk[4], sv[4], sb[4], so[4];
  int causal;
  int bq, nq;          // rows per q tile, q tiles per (b, h)
  int row_tiles;       // 16-row warp tiles per CTA
  int vq, vk, vv, vo;  // 16-byte rows
  int kv_same;         // k and v are one tensor: staged once
};

template <int DP>
struct FwdShape {
  static constexpr int kSplit = DP >= 256 ? 2 : 1;  // warps sharing 16 rows
  static constexpr int kDW = DP / kSplit;           // output columns a warp
  static constexpr int kLd = DP + 8;                // shared row (elements)
  static constexpr int kBK = 16;                    // keys per tile
};

// kRes: K1 + residuals. Registers: at most 85 a thread for K1 at D <= 64
// (five 5-warp serve CTAs per SM), 128 otherwise (two 8-warp mixer CTAs
// per SM); ptxas spills nothing (a cap of 64 ran faster at the serve shape
// but spilled).
template <int DP, bool kRes>
__global__ void __launch_bounds__(kMaxWarps * 32, DP <= 64 && !kRes ? 3 : 2)
flash_fwd_tc_kernel(const TcParams p) {
  using Shape = FwdShape<DP>;
  constexpr int LD = Shape::kLd, DW = Shape::kDW, kBK = Shape::kBK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + p.row_tiles * 16 * LD;
  const int tile_elems = kBK * LD;
  const int stage_elems = (p.kv_same ? 1 : 2) * tile_elems;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rt = warp / Shape::kSplit, dh = warp % Shape::kSplit;
  const int g = lane >> 2, t = lane & 3;

  int cell = blockIdx.x;
  const int qt = cell % p.nq;
  cell /= p.nq;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int q0 = qt * p.bq;
  const int rows = min(p.bq, p.Tq - q0);

  const bf16* q = p.q + b * p.sq[0] + h * p.sq[1] + (int64_t)q0 * p.sq[2];
  const bf16* k = p.k + b * p.sk[0] + h * p.sk[1];
  const bf16* v = p.v + b * p.sv[0] + h * p.sv[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];

  auto load_kv = [&](int j) {
    const int k0 = j * kBK;
    const int kc = min(kBK, p.Tk - k0);
    bf16* ks = kv_s + (j & 1) * stage_elems;
    stage_rows(ks, LD, k + (int64_t)k0 * p.sk[2], p.sk[2], p.sk[3], kc, kBK,
               p.D, DP, p.vk, tid, nthreads);
    if (!p.kv_same)
      stage_rows(ks + tile_elems, LD, v + (int64_t)k0 * p.sv[2], p.sv[2],
                 p.sv[3], kc, kBK, p.D, DP, p.vv, tid, nthreads);
  };

  stage_rows(q_s, LD, q, p.sq[2], p.sq[3], rows, p.row_tiles * 16, p.D, DP,
             p.vq, tid, nthreads);
  load_kv(0);
  cp_async_commit();

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kPad, kPad};
  float l_run[2] = {0.f, 0.f};   // this thread's columns; quad-summed at end
  int arg_run[2] = {-1, -1};     // kRes: key of the running max if computed
  const bf16* q_warp = q_s + (16 * rt + (lane & 15)) * LD + (lane >> 4) * 8;
  const int row_a = q0 + 16 * rt + g;   // global row of c0, c1 (c2, c3: +8)

  const int n_kt = (p.Tk + kBK - 1) / kBK;
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv_s + (j & 1) * stage_elems;
    const bf16* vs = p.kv_same ? ks : ks + tile_elems;
    const int k0 = j * kBK;
    const int kc = min(kBK, p.Tk - k0);

    // S = Q K^T for 16 rows x kBK keys (pairs of n8 tiles past Tk skipped);
    // Q fragments are reloaded from shared memory (registers decide the
    // occupancy, and the occupancy the speed)
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const bf16* k_lane =
        ks + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_warp + 16 * kk);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        if (np * 16 < kc) {
          uint32_t bb[4];
          ldmatrix_x4(bb, k_lane + np * 16 * LD + 16 * kk);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }

    // masks, then the online softmax on the fragment. Columns past Tk
    // (zero-filled K rows, S = 0) take -1e30 and so never enter a row.
    float mx[2] = {kPad, kPad};
    int arg[2] = {-1, -1};   // kRes: key of the tile max if it was computed
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        float x = s[n][e];
        bool computed = false;
        if (col >= kc) {
          x = kPad;
        } else {
          computed = true;
          if (bias != nullptr && row < p.Tq) {
            const float bb =
                bias[(int64_t)row * p.sb[2] + (int64_t)(k0 + col) * p.sb[3]];
            if (bb != 0.f) {
              x = bb;
              computed = false;
            }
          }
          if (p.causal && k0 + col > row) {
            x = kNegMask;
            computed = false;
          }
        }
        s[n][e] = x;
        if constexpr (kRes) {
          if (x > mx[e >> 1]) {
            mx[e >> 1] = x;
            arg[e >> 1] = computed ? k0 + col : -1;
          }
        } else {
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, mx[r], off);
        if constexpr (kRes) {
          // (value, key) in one total order, so the quad agrees on both
          const int oa = __shfl_xor_sync(0xffffffffu, arg[r], off);
          if (o > mx[r] || (o == mx[r] && oa > arg[r])) {
            mx[r] = o;
            arg[r] = oa;
          }
        } else {
          mx[r] = fmaxf(mx[r], o);
        }
      }
      if constexpr (kRes) {
        if (mx[r] > m_run[r]) arg_run[r] = arg[r];
      }
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = pv;
        l_run[e >> 1] += pv;
      }
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S fragment, V by ldmatrix.trans
    const bf16* v_lane = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         dh * DW + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk * 16 < kc) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < DW / 16; ++nd) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, v_lane + kk * 16 * LD + nd * 16);
          mma_bf16(acc[2 * nd], a, bb[0], bb[1]);
          mma_bf16(acc[2 * nd + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  // O = acc / l, staged in this warp's own block of the finished Q tile
  bf16* o_s = q_s + 16 * rt * LD + dh * DW;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    *reinterpret_cast<uint32_t*>(o_s + g * LD + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] / l_row[0], acc[n][1] / l_row[0]);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * LD + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] / l_row[1], acc[n][3] / l_row[1]);
  }
  __syncwarp();
  const int wrows = min(max(rows - 16 * rt, 0), 16);
  bf16* o = p.o + b * p.so[0] + h * p.so[1] +
            (int64_t)(q0 + 16 * rt) * p.so[2];
  store_block(o, p.so[2], p.so[3], o_s, LD, wrows, dh * DW, DW, p.D, p.vo,
              lane);
  // K1 + residuals: the final row max and denominator. Where the max is a
  // computed logit, it is recomputed once in f64 from the bf16 inputs (the
  // products are exact, the sum all but exact) and rounded once, and l is
  // rescaled to it: m is then the correctly rounded row max whatever order
  // the tensor cores summed in, where two f32 summation orders differ by
  // more than 1e-5 relative on rows whose max is near 0 (PERF.md).
  if constexpr (kRes) {
    if (dh == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * rt + g + 8 * r;
        const int key = arg_run[r];   // one value across the quad
        double dot = 0.0;
        if (key >= 0 && row < rows) {
          const bf16* qr = q + (int64_t)row * p.sq[2];
          const bf16* kr = k + (int64_t)key * p.sk[2];
          if (p.vq && p.vk) {   // 16-byte chunks; a bf16 product is exact
            for (int c = 8 * t; c < p.D; c += 32) {
              const uint4 qa = *reinterpret_cast<const uint4*>(qr + c);
              const uint4 ka = *reinterpret_cast<const uint4*>(kr + c);
              const bf16* qe = reinterpret_cast<const bf16*>(&qa);
              const bf16* ke = reinterpret_cast<const bf16*>(&ka);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                dot += (double)(__bfloat162float(qe[e]) *
                                __bfloat162float(ke[e]));
            }
          } else {
            for (int d = t; d < p.D; d += 4)
              dot += (double)(__bfloat162float(qr[(int64_t)d * p.sq[3]]) *
                              __bfloat162float(kr[(int64_t)d * p.sk[3]]));
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (key >= 0) {
          const float m_exact = (float)dot;
          l_row[r] *= expf(m_run[r] - m_exact);
          m_run[r] = m_exact;
        }
      }
      if (t == 0) {
        const int64_t base =
            ((int64_t)b * p.H + h) * p.Tq + q0 + 16 * rt + g;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (16 * rt + g + 8 * r < rows) {
            p.m[base + 8 * r] = m_run[r];
            p.l[base + 8 * r] = l_row[r];
          }
      }
    }
  }
}

template <int DP, bool kRes>
cudaError_t launch(const TcParams& p, cudaStream_t stream) {
  using Shape = FwdShape<DP>;
  const size_t smem =
      sizeof(bf16) * Shape::kLd *
      ((size_t)p.row_tiles * 16 + 2 * (p.kv_same ? 1 : 2) * (size_t)Shape::kBK);
  auto kernel = flash_fwd_tc_kernel<DP, kRes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nq;
  kernel<<<(unsigned)grid, p.row_tiles * Shape::kSplit * 32, smem, stream>>>(
      p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const TcParams& p, cudaStream_t stream) {
  return p.m != nullptr ? launch<DP, true>(p, stream)
                        : launch<DP, false>(p, stream);
}

}  // namespace

extern "C" {

// K1 and K1 + residuals for bf16 q, k, v, o; arguments as t2o_flash_fwd
// (flash_fwd.cu), which validates them and calls this for dtype 1.
int t2o_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* m, float* l, int B,
                       int H, int Tq, int Tk, int D, const int64_t* strides,
                       int causal, void* stream) {
  TcParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = bias;
  p.o = static_cast<bf16*>(o);
  p.m = m;
  p.l = l;
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  bool same_strides = true;
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.sb[i] = strides[12 + i];
    p.so[i] = strides[16 + i];
    same_strides = same_strides && p.sk[i] == p.sv[i];
  }
  p.causal = causal;
  p.kv_same = k == v && same_strides;
  p.vq = rows_of_8(q, p.sq, D);
  p.vk = rows_of_8(k, p.sk, D);
  p.vv = rows_of_8(v, p.sv, D);
  p.vo = rows_of_8(o, p.so, D);
  const int dp = padded_head_dim(D);
  const int split = dp >= 256 ? 2 : 1;
  balanced_tiles(Tq, 16 * (kMaxWarps / split), &p.bq, &p.nq);
  p.row_tiles = (p.bq + 15) / 16;
  if ((int64_t)B * H * p.nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return (int)launch<16>(p, s);
    case 32: return (int)launch<32>(p, s);
    case 64: return (int)launch<64>(p, s);
    case 128: return (int)launch<128>(p, s);
    default: return (int)launch<256>(p, s);
  }
}

}  // extern "C"
