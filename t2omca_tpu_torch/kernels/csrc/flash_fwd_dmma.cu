// Flash-attention forward, f32, on Hopper's FP64 tensor cores (sm_90a):
// mma.sync m16n8k4 with f64 operands and f64 accumulation.
//
// Replaces, for f32 inputs, the TPU kernel `_flash_attention_kernel`
// (t2omca_tpu/kernels/attention.py:115) in both of its launches: K1 at
// :392 (the serve path and the learner's target unrolls) and K1 +
// residuals at :383 (the learner's online unrolls; also writes each row's
// final running max m and denominator l). t2o_flash_fwd (flash_fwd.cu)
// validates the arguments and calls this file for dtype 0; the bf16 body
// is flash_fwd_tc.cu. The function and its semantics are those of
// flash_fwd_tc.cu: a nonzero bias REPLACES the logit, causal columns take
// -1e9, the running max starts at -1e30 and key-tail padding never enters
// a row (an all-masked row is the uniform mean of the real values,
// m = -1e9, l = Tk).
//
// Why f64 and not 3xTF32: the output is correctly rounded. Every f32 input
// converts to f64 exactly, the tensor cores form the products exactly and
// sum them in f64, and the softmax runs in f64, so the one rounding is the
// final one to f32. 3xTF32 (as the f32 K2 and K3 do it) is as accurate as
// f32 but not more: the tensor cores truncate each f32 accumulation. On
// the H100 the learner's f32 pallas-against-xla check (chip_smoke.py
// [train], dense path, 151 recurrent steps at full width) turned that into
// a clipped-gradient difference of 1.21e-3 of its tensor's max against a
// limit of 1e-3, as did an f32 forward summed in another order (1.05e-3)
// and the exact output perturbed by 0.25 ulp (1.17e-3), while the exact
// output rounded once gave 7.91e-4 (PERF.md, section 6).
//
// Bound on this card: bytes at the serve and agent shapes (serve (4096, 4,
// 65, 65, 64): ~1.09 GB, 0.33 ms; agent (2048, 1, 4, 65, 256): 0.086 ms);
// operations at the mixer shape (32, 1, 268, 131, 256: 4 B H Tq Tk D FLOPs
// at the FP64 tensor-core peak of 67 TFLOP/s, 0.017 ms). The design:
//
// * FlashAttention-2 structure as in the bf16 body: one warp owns 16 query
//   rows and the online softmax runs on the S fragment in registers (row
//   max and sum over the lanes of a quad), in f64. At D >= 128 the warps of
//   a row tile split D (64 columns each: four warps at D = 256): each sums
//   S over its columns of D and owns the same output columns, so each
//   operand element converts to f64 once per warp that uses it. The
//   partial S tiles meet in shared memory, and every warp sums them in the
//   same order, so all form the same S, m and l.
// * P stays in registers: within one product the k index may be permuted,
//   so P V takes the k4 step s of key tile n as keys 8n + 2t + s, and S's
//   C elements (c_s, c_{2+s}) are P's A fragment (a0, a1); V's B element is
//   row 8n + 2t + s of the staged tile at column g.
// * Q, then 16-key K and V tiles, come in by cp.async as f32 (zero-filled
//   past Tk and past D) into a two-stage ring, staged once when k is v;
//   rows that are not 16-byte aligned are gathered with scalar loads. Each
//   operand converts to f64 as it is loaded into a fragment (converting Q
//   and each tile once per CTA into f64 shared memory instead cost
//   registers and occupancy and ran the serve shape slower on the H100).
//   Shared rows are padded by 4 floats (a row is 4 banks on from the one
//   before), so the scalar loads of Q and K (row g, column t) and of V
//   (rows 2t + s, column g) hit 32 distinct banks.
// * Grid: one CTA per (b, h, q tile): up to 128 rows at D <= 64 (the serve
//   shape: one CTA of 5 warps per (b, h), three an SM), 32 rows at D = 128,
//   16 rows at D = 256 (agent: one CTA of 4 warps per b; mixer: 17 per b;
//   62 KB of shared memory with k is v, three CTAs an SM; eight warps of
//   32 columns instead ran slower). n8 tiles past Tk are skipped.
//   One barrier a key tile, and one more where warps split D.
// * K1 + residuals writes m as the f64 row max rounded once (the correctly
//   rounded max of the exact logits) and l relative to that f32 m.
// * The output is staged through the (finished) Q region of shared memory
//   and leaves in 16-byte stores where the rows allow them.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2o;

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;   // nullptr = no mask; else (B, H, Tq, Tk) by strides
  float* o;
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
struct FwdF64Shape {
  // warps sharing 16 rows: at D >= 128 each sums S over 64 columns of D
  // and owns the same 64 output columns
  static constexpr int kSplit = DP >= 128 ? DP / 64 : 1;
  static constexpr int kDW = DP / kSplit;           // columns a warp
  static constexpr int kLd = DP + 4;                // shared row (floats)
  static constexpr int kBK = 16;                    // keys per tile
  static constexpr int kStages = 2;                 // K/V ring depth
  static constexpr int kRowTiles = DP <= 64 ? 8 : DP == 128 ? 2 : 1;
  static constexpr int kThreads = kRowTiles * kSplit * 32;
};

constexpr int kPld = 24;   // row of a partial S tile (doubles)

// Registers: at most 128 a thread at D <= 64, so that three 5-warp serve
// CTAs fit an SM (a cap of 255 left 172 and two CTAs, and ran the serve
// shape 2.0x slower on the H100), and at most 170 above, so that three
// 4-warp CTAs fit where shared memory allows them (k is v: 11% faster at
// the agent shape, 20% at the mixer's); ptxas spills nothing under either
// (scripts/torch_kernel_variants.py times the alternatives).
template <int DP, bool kRes>
__global__ void __launch_bounds__(FwdF64Shape<DP>::kThreads,
                                  DP <= 64 ? 2 : 3)
flash_fwd_dmma_kernel(const F32Params p) {
  using Shape = FwdF64Shape<DP>;
  constexpr int LD = Shape::kLd, DW = Shape::kDW, kBK = Shape::kBK;
  constexpr int W = Shape::kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q (f32) | the partial S tiles (f64) when warps split D | the K/V ring
  float* q_s = reinterpret_cast<float*>(smem_raw);
  double* part = reinterpret_cast<double*>(q_s + p.row_tiles * 16 * LD);
  float* kv_s = reinterpret_cast<float*>(
      part + (W > 1 ? p.row_tiles * W * 16 * kPld : 0));
  const int tile_elems = kBK * LD;
  const int stage_elems = (p.kv_same ? 1 : 2) * tile_elems;
  const int n_kt = (p.Tk + kBK - 1) / kBK;
  const int stages = min(Shape::kStages, n_kt);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rt = warp / W, dh = warp % W;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = dh * DW;

  int cell = blockIdx.x;
  const int qt = cell % p.nq;
  cell /= p.nq;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int q0 = qt * p.bq;
  const int rows = min(p.bq, p.Tq - q0);

  const float* q = p.q + b * p.sq[0] + h * p.sq[1] + (int64_t)q0 * p.sq[2];
  const float* k = p.k + b * p.sk[0] + h * p.sk[1];
  const float* v = p.v + b * p.sv[0] + h * p.sv[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];

  auto load_kv = [&](int j) {
    const int k0 = j * kBK;
    const int kc = min(kBK, p.Tk - k0);
    float* ks = kv_s + (j % stages) * stage_elems;
    stage_rows(ks, LD, k + (int64_t)k0 * p.sk[2], p.sk[2], p.sk[3], kc, kBK,
               p.D, DP, p.vk, tid, nthreads);
    if (!p.kv_same)
      stage_rows(ks + tile_elems, LD, v + (int64_t)k0 * p.sv[2], p.sv[2],
                 p.sv[3], kc, kBK, p.D, DP, p.vv, tid, nthreads);
  };
  stage_rows(q_s, LD, q, p.sq[2], p.sq[3], rows, p.row_tiles * 16, p.D, DP,
             p.vq, tid, nthreads);
  // Q and tiles 0 .. kStages - 2 in flight; one commit group a tile (empty
  // past the last), so "tile j has landed" is always wait<kStages - 2>
#pragma unroll
  for (int j = 0; j < Shape::kStages - 1; ++j) {
    if (j < n_kt) load_kv(j);
    cp_async_commit();
  }

  double acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0;
  double m_run[2] = {kPad, kPad};
  double l_run[2] = {0.0, 0.0};   // this thread's columns; quad-summed at end
  const float* q_lane = q_s + (16 * rt + g) * LD + c0 + t;
  const int row_a = q0 + 16 * rt + g;   // global row of c0, c1 (c2, c3: +8)

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait<Shape::kStages - 2>();
    __syncthreads();   // tile j has landed; every warp is done with j - 1
    if (j + Shape::kStages - 1 < n_kt)
      load_kv(j + Shape::kStages - 1);   // into the stage tile j - 1 used
    cp_async_commit();
    const float* ks = kv_s + (j % stages) * stage_elems;
    const float* vs = p.kv_same ? ks : ks + tile_elems;
    const int k0 = j * kBK;
    const int kc = min(kBK, p.Tk - k0);

    // S = Q K^T for 16 rows x kBK keys over this warp's columns of D
    double s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0;
#pragma unroll
    for (int kk = 0; kk < DW / 4; ++kk) {
      const double a0 = q_lane[4 * kk], a1 = q_lane[8 * LD + 4 * kk];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        if (n * 8 < kc)
          mma_f64(s[n], a0, a1, ks[(8 * n + g) * LD + c0 + 4 * kk + t]);
    }
    if constexpr (W > 1) {
      // the partials of the row tile's warps meet in shared memory; every
      // warp sums them in the same order, so all form the same S
      double* pw = part + (rt * W + dh) * 16 * kPld;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<double2*>(pw + (g + 8 * r) * kPld + 8 * n +
                                      2 * t) =
              make_double2(s[n][2 * r], s[n][2 * r + 1]);
      __syncthreads();   // every warp's partials are in
      const double* pr = part + rt * W * 16 * kPld;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          double2 sum = make_double2(0.0, 0.0);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const double2 x = *reinterpret_cast<const double2*>(
                pr + w * 16 * kPld + (g + 8 * r) * kPld + 8 * n + 2 * t);
            sum.x += x.x;
            sum.y += x.y;
          }
          s[n][2 * r] = sum.x;
          s[n][2 * r + 1] = sum.y;
        }
    }

    // masks, then the online softmax on the fragment. Columns past Tk
    // (zero-filled K rows, S = 0) take -1e30 and so never enter a row.
    double mx[2] = {kPad, kPad};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        double x = s[n][e];
        if (col >= kc) {
          x = kPad;
        } else {
          if (bias != nullptr && row < p.Tq) {
            const float bb =
                bias[(int64_t)row * p.sb[2] + (int64_t)(k0 + col) * p.sb[3]];
            if (bb != 0.f) x = bb;
          }
          if (p.causal && k0 + col > row) x = kNegMask;
        }
        s[n][e] = x;
        mx[e >> 1] = fmax(mx[e >> 1], x);
      }
    double alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        mx[r] = fmax(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      const double m_new = fmax(m_run[r], mx[r]);
      alpha[r] = exp(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double pv = exp(s[n][e] - m_run[e >> 1]);
        s[n][e] = pv;
        l_run[e >> 1] += pv;
      }

    // O = O * alpha + P V: the k4 step s of key tile n takes keys
    // 8n + 2t + s, whose P values are this thread's c_s and c_{2+s}
    const float* v_lane = vs + 2 * t * LD + c0 + g;
#pragma unroll
    for (int nd = 0; nd < DW / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        if (n * 8 < kc) {
          const float* vr = v_lane + 8 * n * LD + 8 * nd;
          mma_f64(acc[nd], s[n][0], s[n][2], vr[0]);
          mma_f64(acc[nd], s[n][1], s[n][3], vr[LD]);
        }
    }
  }

  double l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  // O = acc / l rounded once, staged in this warp's own block of the
  // finished Q (and partial S) region
  __syncthreads();   // every warp is done reading Q and the partials
  constexpr int LDO = DW + 4;
  float* o_s = q_s + (rt * W + dh) * 16 * LDO;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    *reinterpret_cast<float2*>(o_s + g * LDO + 8 * n + 2 * t) = make_float2(
        (float)(acc[n][0] / l_row[0]), (float)(acc[n][1] / l_row[0]));
    *reinterpret_cast<float2*>(o_s + (g + 8) * LDO + 8 * n + 2 * t) =
        make_float2((float)(acc[n][2] / l_row[1]),
                    (float)(acc[n][3] / l_row[1]));
  }
  __syncwarp();
  const int wrows = min(max(rows - 16 * rt, 0), 16);
  float* o = p.o + b * p.so[0] + h * p.so[1] +
             (int64_t)(q0 + 16 * rt) * p.so[2];
  store_block(o, p.so[2], p.so[3], o_s, LDO, wrows, c0, DW, p.D, p.vo, lane);
  // K1 + residuals: m rounded once from the f64 row max, l relative to it
  if constexpr (kRes) {
    if (dh == 0 && t == 0) {
      const int64_t base = ((int64_t)b * p.H + h) * p.Tq + q0 + 16 * rt + g;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (16 * rt + g + 8 * r < rows) {
          const float m32 = (float)m_run[r];
          p.m[base + 8 * r] = m32;
          p.l[base + 8 * r] =
              (float)(l_row[r] * exp(m_run[r] - (double)m32));
        }
    }
  }
}

template <int DP, bool kRes>
cudaError_t launch(const F32Params& p, cudaStream_t stream) {
  using Shape = FwdF64Shape<DP>;
  const int stages =
      min(Shape::kStages, (p.Tk + Shape::kBK - 1) / Shape::kBK);
  const size_t smem =
      sizeof(float) * Shape::kLd *
          ((size_t)p.row_tiles * 16 +
           (size_t)stages * (p.kv_same ? 1 : 2) * Shape::kBK) +
      sizeof(double) *
          (Shape::kSplit > 1 ? (size_t)p.row_tiles * Shape::kSplit * 16 * kPld
                             : 0);
  auto kernel = flash_fwd_dmma_kernel<DP, kRes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nq;
  kernel<<<(unsigned)grid, p.row_tiles * Shape::kSplit * 32, smem, stream>>>(
      p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(F32Params& p, cudaStream_t stream) {
  balanced_tiles(p.Tq, 16 * FwdF64Shape<DP>::kRowTiles, &p.bq, &p.nq);
  p.row_tiles = (p.bq + 15) / 16;
  if ((int64_t)p.B * p.H * p.nq > 0x7fffffffLL) return cudaErrorInvalidValue;
  return p.m != nullptr ? launch<DP, true>(p, stream)
                        : launch<DP, false>(p, stream);
}

}  // namespace

extern "C" {

// K1 and K1 + residuals for f32 q, k, v, o; arguments as t2o_flash_fwd
// (flash_fwd.cu), which validates them and calls this for dtype 0.
int t2o_flash_fwd_f32(const void* q, const void* k, const void* v,
                      const float* bias, void* o, float* m, float* l, int B,
                      int H, int Tq, int Tk, int D, const int64_t* strides,
                      int causal, void* stream) {
  F32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.bias = bias;
  p.o = static_cast<float*>(o);
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
  p.vq = D % 4 == 0 && rows_of_4(q, p.sq, 0);
  p.vk = D % 4 == 0 && rows_of_4(k, p.sk, 0);
  p.vv = D % 4 == 0 && rows_of_4(v, p.sv, 0);
  p.vo = D % 4 == 0 && rows_of_4(o, p.so, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(D)) {
    case 16: return (int)launch<16>(p, s);
    case 32: return (int)launch<32>(p, s);
    case 64: return (int)launch<64>(p, s);
    case 128: return (int)launch<128>(p, s);
    default: return (int)launch<256>(p, s);
  }
}

}  // extern "C"
