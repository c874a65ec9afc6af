// Flash-attention dK/dV backward, bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces, for bf16 inputs, the TPU kernel `_flash_attention_bwd_dkv_kernel`
// (t2omca_tpu/kernels/attention.py:253, launched at :464), K3. The f32 K3
// is the 3xTF32 body of flash_bwd_dkv_3xtf32.cu; t2o_flash_bwd_dkv
// (flash_bwd.cu) validates the arguments and calls this file for bf16.
// Per (b, h) and key tile, looping over the query tiles, it recomputes
// with the forward's semantics (replacement mask, causal -1e9, P from the
// residuals m and l of K1 + residuals):
//
//   S^T = K Q^T,  P^T = exp(S^T - m) / l,  dP^T = V dO^T,
//   dS^T = P^T o (dP^T - Delta), zeroed where the forward replaced the logit
//   dV += P^T dO  (the full P)         dK += dS^T Q
//
// with Delta = rowsum(dO o O) from the caller's torch reduction. dk and dv
// are written separately, in the input dtype (autograd sums them when k is
// v, after rounding, as JAX does).
//
// Bound on this card: bytes (at the learner's agent shape, 2048 x (65 keys +
// 4 queries) x 256, k, v, dk and dv are ~270 MB against ~1 GFLOP). The
// design:
//
// * All four products on the tensor cores by mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). A warp owns 16 keys, so S^T and dP^T come out with
//   keys as rows, and their C fragments, rounded to bf16 in registers, are
//   directly the A operands of P^T dO and dS^T Q: no transpose passes
//   through shared memory. dO and Q enter as B operands by ldmatrix (plain
//   for S^T and dP^T, .trans for dV and dK).
// * Registers: 16 keys x 256 columns of both dK and dV would take 256 f32
//   registers a thread, so at D = 256 four warps share the 16 keys, each
//   owning 64 output columns of both (64 registers) and each recomputing the
//   16 x 16 S^T and dP^T tiles itself (the products are cheap here; the
//   bytes are not).
// * K and V are staged once per CTA (once when they are one tensor, the
//   query-slice call); the 16-query tiles of Q, dO, m, l and Delta stream
//   through a two-stage cp.async ring when there is more than one.
// * Each CTA owns one balanced tile of at most 16 keys: no atomics,
//   deterministic sums. The agent shape runs 5 CTAs of 13 keys per b (10240
//   CTAs of 4 warps, one q step each), the mixer shape 9 CTAs of 15 keys per
//   b (288 CTAs of 4 warps, 17 q steps each). Of the tile caps timed on the
//   H100 (64, 32, 16 keys), 16 ran fastest: registers (128 a thread at
//   D = 256) decide how many warps an SM holds, and small CTAs pack them
//   best.
// * dK and dV leave through shared memory in 16-byte stores.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2o;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 16;          // queries per step
constexpr int kBK = 16;          // keys per CTA (one warp tile)

struct DkvParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;        // dO
  const float* bias;    // nullptr = no mask; else (B, H, Tq, Tk) by strides
  const float* m;       // (B, H, Tq) contiguous: residuals of K1
  const float* l;
  const float* delta;   // (B, H, Tq) contiguous: rowsum(dO o O)
  bf16* dk;
  bf16* dv;
  int B, H, Tq, Tk, D;
  int64_t sq[4], sk[4], sv[4], sg[4], sb[4], sdk[4], sdv[4];
  int causal;
  int bk, nk;           // keys per tile (<= kBK), key tiles per (b, h)
  int nq;               // query steps per (b, h)
  int vq, vk, vv, vg, vdk, vdv;
  int kv_same;
};

template <int DP>
struct DkvShape {
  static constexpr int kSplit = DP >= 64 ? DP / 64 : 1;  // warps per 16 keys
  static constexpr int kDW = DP / kSplit;                // columns a warp
  static constexpr int kLd = DP + 8;
  // 128 registers a thread at D > 64 (64 of them the accumulators); at
  // D <= 64 a one-warp CTA may take more, which it needs not to spill
  static constexpr int kMinBlocks = DP > 64 ? 16 / kSplit : 8;
};

template <int DP>
__global__ void __launch_bounds__(DkvShape<DP>::kSplit * 32,
                                  DkvShape<DP>::kMinBlocks)
flash_bwd_dkv_tc_kernel(const DkvParams p) {
  using Shape = DkvShape<DP>;
  constexpr int LD = Shape::kLd, DW = Shape::kDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = p.kv_same ? k_s : k_s + kBK * LD;
  bf16* ring = k_s + (p.kv_same ? 1 : 2) * kBK * LD;
  const int stages = p.nq > 1 ? 2 : 1;
  float* stats = reinterpret_cast<float*>(ring + stages * 2 * kBQ * LD);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int dh = tid >> 5, lane = tid & 31;   // warp = column block
  const int g = lane >> 2, t = lane & 3;

  int cell = blockIdx.x;
  const int kt = cell % p.nk;
  cell /= p.nk;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int k0 = kt * p.bk;
  const int kcols = min(p.bk, p.Tk - k0);

  const bf16* q = p.q + b * p.sq[0] + h * p.sq[1];
  const bf16* gr = p.g + b * p.sg[0] + h * p.sg[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];
  const int64_t row_base = ((int64_t)b * p.H + h) * p.Tq;

  stage_rows(k_s, LD, p.k + b * p.sk[0] + h * p.sk[1] + (int64_t)k0 * p.sk[2],
             p.sk[2], p.sk[3], kcols, kBK, p.D, DP, p.vk, tid, nthreads);
  if (!p.kv_same)
    stage_rows(v_s, LD,
               p.v + b * p.sv[0] + h * p.sv[1] + (int64_t)k0 * p.sv[2],
               p.sv[2], p.sv[3], kcols, kBK, p.D, DP, p.vv, tid, nthreads);

  auto load_q = [&](int j) {
    const int q0 = j * kBQ;
    const int qv = min(kBQ, p.Tq - q0);
    bf16* qs = ring + (j % stages) * 2 * kBQ * LD;
    stage_rows(qs, LD, q + (int64_t)q0 * p.sq[2], p.sq[2], p.sq[3], qv, kBQ,
               p.D, DP, p.vq, tid, nthreads);
    stage_rows(qs + kBQ * LD, LD, gr + (int64_t)q0 * p.sg[2], p.sg[2],
               p.sg[3], qv, kBQ, p.D, DP, p.vg, tid, nthreads);
    float* st = stats + (j % stages) * 3 * kBQ;
    for (int i = tid; i < 3 * kBQ; i += nthreads) {
      const int which = i / kBQ, r = i - which * kBQ;
      const float* src = which == 0 ? p.m : which == 1 ? p.l : p.delta;
      st[i] = r < qv ? src[row_base + q0 + r] : 0.f;
    }
  };
  load_q(0);
  cp_async_commit();

  float acc_k[DW / 8][4], acc_v[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }
  const int key_a = k0 + g;   // global key of c0, c1 (c2, c3: +8)
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dh * DW + (lane >> 4) * 8;

  for (int j = 0; j < p.nq; ++j) {
    if (j + 1 < p.nq) {
      load_q(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = ring + (j % stages) * 2 * kBQ * LD;
    const bf16* gs = qs + kBQ * LD;
    const float* ms = stats + (j % stages) * 3 * kBQ;
    const float* ls = ms + kBQ;
    const float* ds = ls + kBQ;
    const int q0 = j * kBQ;
    const int qv = min(kBQ, p.Tq - q0);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries each
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = 0.f;
        dpt[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], bb[4];
      ldmatrix_x4(a, k_s + a_off + 16 * kk);
      ldmatrix_x4(bb, qs + b_off + 16 * kk);
      mma_bf16(st[0], a, bb[0], bb[1]);
      mma_bf16(st[1], a, bb[2], bb[3]);
      ldmatrix_x4(a, v_s + a_off + 16 * kk);
      ldmatrix_x4(bb, gs + b_off + 16 * kk);
      mma_bf16(dpt[0], a, bb[0], bb[1]);
      mma_bf16(dpt[1], a, bb[2], bb[3]);
    }

    // P^T and dS^T in f32 on the fragment; padded queries give 0
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + 8 * (e >> 1);
        const int qi = 8 * n + 2 * t + (e & 1);
        const int qrow = q0 + qi;
        float pv = 0.f, dsv = 0.f;
        if (qi < qv) {
          float x = st[n][e];
          bool replaced = false;
          if (bias != nullptr && key < p.Tk) {
            const float bb =
                bias[(int64_t)qrow * p.sb[2] + (int64_t)key * p.sb[3]];
            if (bb != 0.f) {
              x = bb;
              replaced = true;
            }
          }
          if (p.causal && key > qrow) {
            x = kNegMask;
            replaced = true;
          }
          pv = expf(x - ms[qi]) / ls[qi];
          dsv = replaced ? 0.f : pv * (dpt[n][e] - ds[qi]);
        }
        st[n][e] = pv;
        dpt[n][e] = dsv;
      }

    // dV += P^T dO, dK += dS^T Q (bf16 operands from the fragments)
    const uint32_t ap[4] = {pack_bf16(st[0][0], st[0][1]),
                            pack_bf16(st[0][2], st[0][3]),
                            pack_bf16(st[1][0], st[1][1]),
                            pack_bf16(st[1][2], st[1][3])};
    const uint32_t ad[4] = {pack_bf16(dpt[0][0], dpt[0][1]),
                            pack_bf16(dpt[0][2], dpt[0][3]),
                            pack_bf16(dpt[1][0], dpt[1][1]),
                            pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
    for (int nd = 0; nd < DW / 16; ++nd) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, gs + bt_off + 16 * nd);
      mma_bf16(acc_v[2 * nd], ap, bb[0], bb[1]);
      mma_bf16(acc_v[2 * nd + 1], ap, bb[2], bb[3]);
      ldmatrix_x4_trans(bb, qs + bt_off + 16 * nd);
      mma_bf16(acc_k[2 * nd], ad, bb[0], bb[1]);
      mma_bf16(acc_k[2 * nd + 1], ad, bb[2], bb[3]);
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  // dK, then dV, staged in this warp's own block of the finished K tile
  bf16* blk = k_s + dh * DW;
  stage_frag(blk, LD, acc_k, g, t);
  __syncwarp();
  store_block(p.dk + b * p.sdk[0] + h * p.sdk[1] + (int64_t)k0 * p.sdk[2],
              p.sdk[2], p.sdk[3], blk, LD, kcols, dh * DW, DW, p.D, p.vdk,
              lane);
  __syncwarp();
  stage_frag(blk, LD, acc_v, g, t);
  __syncwarp();
  store_block(p.dv + b * p.sdv[0] + h * p.sdv[1] + (int64_t)k0 * p.sdv[2],
              p.sdv[2], p.sdv[3], blk, LD, kcols, dh * DW, DW, p.D, p.vdv,
              lane);
}

template <int DP>
cudaError_t launch(const DkvParams& p, cudaStream_t stream) {
  using Shape = DkvShape<DP>;
  const int stages = p.nq > 1 ? 2 : 1;
  const size_t smem =
      sizeof(bf16) * Shape::kLd *
          ((p.kv_same ? 1 : 2) * (size_t)kBK +
           (size_t)stages * 2 * kBQ) +
      sizeof(float) * stages * 3 * kBQ;
  auto kernel = flash_bwd_dkv_tc_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nk;
  kernel<<<(unsigned)grid, Shape::kSplit * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 for bf16 q, k, v, dO, dk, dv; arguments as t2o_flash_bwd_dkv
// (flash_bwd.cu), which validates them and calls this for dtype 1.
int t2o_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                           const float* bias, const void* g, const float* m,
                           const float* l, const float* delta, void* dk,
                           void* dv, int B, int H, int Tq, int Tk, int D,
                           const int64_t* strides, int causal, void* stream) {
  DkvParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.g = static_cast<const bf16*>(g);
  p.bias = bias;
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
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
    p.sg[i] = strides[12 + i];
    p.sb[i] = strides[16 + i];
    p.sdk[i] = strides[24 + i];
    p.sdv[i] = strides[28 + i];
    same_strides = same_strides && p.sk[i] == p.sv[i];
  }
  p.causal = causal;
  p.kv_same = k == v && same_strides;
  p.vq = rows_of_8(q, p.sq, D);
  p.vk = rows_of_8(k, p.sk, D);
  p.vv = rows_of_8(v, p.sv, D);
  p.vg = rows_of_8(g, p.sg, D);
  p.vdk = rows_of_8(dk, p.sdk, D);
  p.vdv = rows_of_8(dv, p.sdv, D);
  const int dp = padded_head_dim(D);
  balanced_tiles(Tk, kBK, &p.bk, &p.nk);
  p.nq = (Tq + kBQ - 1) / kBQ;
  if ((int64_t)B * H * p.nk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
