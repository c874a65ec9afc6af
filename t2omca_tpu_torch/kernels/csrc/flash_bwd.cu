// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: the
// C entry points of K2 and K3, and the f32 K3 on the CUDA cores.
//
// What runs where:
//   K2 (dq), f32 and bf16    flash_bwd_dq_tc.cu: tensor cores (bf16 on
//                            mma.sync m16n8k16; f32 as 3xTF32 on m16n8k8)
//   K3 (dk, dv), bf16        flash_bwd_tc.cu: tensor cores (m16n8k16)
//   K3 (dk, dv), f32         this file: CUDA cores
// t2o_flash_bwd_dq and t2o_flash_bwd_dkv below validate the arguments and
// dispatch on the dtype.
//
// Replaces the TPU kernels of t2omca_tpu/kernels/attention.py's `_build`
// backward (:402):
//
//   K2 `_flash_attention_bwd_dq_kernel` (:210, launched at :437)  -> dq
//   K3 `_flash_attention_bwd_dkv_kernel` (:253, launched at :464) -> dk, dv
//
// Both recompute the probability tile from (q, k) and the forward's
// residuals exactly as `_recompute_p` (:182) does:
//
//   S = Q K^T, with the forward's replacement mask (a nonzero bias
//       overwrites the logit) and causal fill (-1e9 where col > row)
//   P = exp(S - m) / l                    m, l from K1 + residuals
//   dP = dO V^T
//   dS = P o (dP - Delta), zeroed where the forward REPLACED the logit
//   dQ = dS K        dK = dS^T Q        dV = P^T dO  (the full P: an
//                                       all-masked row's uniform weights
//                                       route cotangent into V)
//
// with Delta = rowsum(dO o O) computed by the caller (a plain torch
// reduction before the launch, as the TPU path does at :413). Everything
// accumulates in f32; dq, dk, dv are written in the input dtype.
//
// Bound on this card: at the learner shapes (agent B=2048, H=1, Tq=4,
// Tk=65, D=256; mixer B=32, H=1, Tq=268, Tk=131, D=256) the kernels read
// q, k, v, dO once each plus the f32 row statistics and write their
// gradients: a few hundred MB at most against a few GFLOP, so both are
// bytes-bound on paper (PERF.md has the numbers). The f32 K3 here is the
// simple design, on CUDA cores:
//
// * One CTA of 256 threads per (b, h, k-tile) whose loop over q-tiles
//   replaces the TPU's sequential grid axis (:270-297). Each CTA owns its
//   output rows, so no atomics are needed and the sums are deterministic.
// * Tiles hold up to 80 rows at D <= 64 and 32 rows otherwise (so K3 at
//   the mixer shape has 5 key tiles per (b, h), 160 CTAs). All four
//   staged slabs (q, dO, k, v) are f32 in shared memory: 137 KB at D=256.
// * The P and dS tiles are computed one element per thread (two D-long
//   dot products from shared memory), then the owned 4x4 output blocks
//   accumulate in registers as in K1's PV phase.
//
// The 3xTF32 helpers of flash_mma.cuh are the way to move it onto the
// tensor cores; see PERF.md for times.

#include "flash_common.cuh"

namespace {

using namespace t2o;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // dO, the output's cotangent, (B, H, Tq, D)
  const float* bias;    // nullptr = no mask; else (B, H, Tq, Tk) by strides
  const float* m;       // (B, H, Tq) contiguous: residuals of K1
  const float* l;
  const float* delta;   // (B, H, Tq) contiguous: rowsum(dO o O)
  void* dk;
  void* dv;
  int B, H, Tq, Tk, D;
  int64_t sq[4], sk[4], sv[4], sg[4], sb[4], sdk[4], sdv[4];
  int causal;
  int bq, nq;    // rows per q tile, q tiles per (b, h)
  int bk, nk;    // keys per k tile, k tiles per (b, h)
  Slab s;        // staged slab geometry
  int vq, vk, vv, vg, vdk, vdv;   // per-tensor 4-element row access
};

// P and dS of one (q-tile, k-tile) pair, one element per thread, from the
// staged slabs: rows i < rows of the q tile starting at q0, columns
// j < kcols of the k tile starting at k0. mr/lr/dr hold the q tile's
// residuals and Delta.
__device__ __forceinline__ void p_ds_tile(
    const BwdParams& p, const float* q_s, const float* g_s, const float* k_s,
    const float* v_s, const float* mr, const float* lr, const float* dr,
    const float* bias, int q0, int rows, int k0, int kcols, float* p_s,
    float* ds_s, int lds) {
  const int ld = p.s.ld;
  for (int u = threadIdx.x; u < rows * kcols; u += kThreads) {
    const int i = u / kcols, j = u - i * kcols;
    const float* qr = q_s + i * ld;
    const float* gr = g_s + i * ld;
    const float* kr = k_s + j * ld;
    const float* vr = v_s + j * ld;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < p.s.dp; d += 4) {
      s = dot4(load4(qr + d), load4(kr + d), s);
      dp = dot4(load4(gr + d), load4(vr + d), dp);
    }
    const int row = q0 + i, col = k0 + j;
    bool replaced = false;
    if (bias != nullptr) {
      const float bb = bias[(int64_t)row * p.sb[2] + (int64_t)col * p.sb[3]];
      if (bb != 0.f) {
        s = bb;
        replaced = true;
      }
    }
    if (p.causal && col > row) {
      s = kNegMask;
      replaced = true;
    }
    const float pv = expf(s - mr[i]) / lr[i];
    p_s[i * lds + j] = pv;
    ds_s[i * lds + j] = replaced ? 0.f : pv * (dp - dr[i]);
  }
}

__device__ __forceinline__ void load_rows(float* m_s, float* l_s, float* d_s,
                                          const BwdParams& p, int b, int h,
                                          int q0, int rows) {
  const int64_t base = ((int64_t)b * p.H + h) * p.Tq + q0;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    m_s[i] = p.m[base + i];
    l_s[i] = p.l[base + i];
    d_s[i] = p.delta[base + i];
  }
}

// K3: dK and dV for one (b, h, k-tile), looping over the q tiles.
// Instantiated for float only: bf16 runs flash_bwd_tc.cu.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.s.ld;
  const int lds = p.bk + 1;
  float* k_s = smem;                  // bk x ld
  float* v_s = k_s + p.bk * ld;       // bk x ld
  float* q_s = v_s + p.bk * ld;       // bq x ld
  float* g_s = q_s + p.bq * ld;       // bq x ld
  float* p_s = g_s + p.bq * ld;       // bq x lds
  float* ds_s = p_s + p.bq * lds;     // bq x lds
  float* m_s = ds_s + p.bq * lds;     // bq each
  float* l_s = m_s + p.bq;
  float* d_s = l_s + p.bq;

  const int tid = threadIdx.x;
  int cell = blockIdx.x;
  const int kt = cell % p.nk;
  cell /= p.nk;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int k0 = kt * p.bk;
  const int kcols = min(p.bk, p.Tk - k0);

  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  const T* g = static_cast<const T*>(p.g) + b * p.sg[0] + h * p.sg[1];
  T* dk = static_cast<T*>(p.dk) + b * p.sdk[0] + h * p.sdk[1];
  T* dv = static_cast<T*>(p.dv) + b * p.sdv[0] + h * p.sdv[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];

  stage(k_s, k + (int64_t)k0 * p.sk[2], p.sk[2], p.sk[3], kcols, p.s, p.vk);
  stage(v_s, v + (int64_t)k0 * p.sv[2], p.sv[2], p.sv[3], kcols, p.s, p.vv);

  // dK and dV blocks owned by this thread: key rows {jg + njg*a},
  // columns 4ch..4ch+3
  const int njg = (kcols + 3) / 4;
  const int nch = p.s.dp / 4;
  const int n_out = njg * nch;
  float4 acc_k[kAccTiles][4], acc_v[kAccTiles][4];
#pragma unroll
  for (int t = 0; t < kAccTiles; ++t)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc_k[t][a] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_v[t][a] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int qt = 0; qt < p.nq; ++qt) {
    const int q0 = qt * p.bq;
    const int rows = min(p.bq, p.Tq - q0);
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    stage(q_s, q + (int64_t)q0 * p.sq[2], p.sq[2], p.sq[3], rows, p.s, p.vq);
    stage(g_s, g + (int64_t)q0 * p.sg[2], p.sg[2], p.sg[3], rows, p.s, p.vg);
    load_rows(m_s, l_s, d_s, p, b, h, q0, rows);
    __syncthreads();
    p_ds_tile(p, q_s, g_s, k_s, v_s, m_s, l_s, d_s, bias, q0, rows, k0,
              kcols, p_s, ds_s, lds);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q on the owned blocks
#pragma unroll
    for (int t = 0; t < kAccTiles; ++t) {
      const int u = tid + t * kThreads;
      if (u < n_out) {
        const int jg = u / nch, ch = u - jg * nch;
        int jc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) jc[a] = min(jg + njg * a, kcols - 1);
        for (int i = 0; i < rows; ++i) {
          const float4 gf = load4(g_s + i * ld + 4 * ch);
          const float4 qf = load4(q_s + i * ld + 4 * ch);
          const float* pr = p_s + i * lds;
          const float* dr = ds_s + i * lds;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            fma4(pr[jc[a]], gf, acc_v[t][a]);
            fma4(dr[jc[a]], qf, acc_k[t][a]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kAccTiles; ++t) {
    const int u = tid + t * kThreads;
    if (u < n_out) {
      const int jg = u / nch, ch = u - jg * nch;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = jg + njg * a;
        if (j < kcols) {
          write4(dk + (int64_t)(k0 + j) * p.sdk[2], p.sdk[3], 4 * ch, p.D,
                 acc_k[t][a], p.vdk);
          write4(dv + (int64_t)(k0 + j) * p.sdv[2], p.sdv[3], 4 * ch, p.D,
                 acc_v[t][a], p.vdv);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)p.bk * p.s.ld + 2 * (size_t)p.bq * p.s.ld +
                       2 * (size_t)p.bq * (p.bk + 1) + 3 * (size_t)p.bq);
  auto kernel = flash_bwd_dkv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nk;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Do the kernels take these sizes and this dtype code?
bool valid_shape(int dtype, int B, int H, int Tq, int Tk, int D) {
  return B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && D >= 1 && D <= 256 &&
         (dtype == 0 || dtype == 1);
}

// Fill the f32 K3's parameters. strides: 32 int64 in elements, four each
// for q, k, v, dO, bias, dq, dk, dv; the bias strides are ignored when bias
// is null, and dq's too. → false for shapes the kernel does not take.
bool make_params(BwdParams* p, const void* q, const void* k, const void* v,
                 const float* bias, const void* g, const float* m,
                 const float* l, const float* delta, void* dk, void* dv,
                 int dtype, int B, int H, int Tq, int Tk, int D,
                 const int64_t* strides, int causal) {
  if (!valid_shape(dtype, B, H, Tq, Tk, D)) return false;
  p->q = q;
  p->k = k;
  p->v = v;
  p->g = g;
  p->bias = bias;
  p->m = m;
  p->l = l;
  p->delta = delta;
  p->dk = dk;
  p->dv = dv;
  p->B = B;
  p->H = H;
  p->Tq = Tq;
  p->Tk = Tk;
  p->D = D;
  for (int i = 0; i < 4; ++i) {
    p->sq[i] = strides[i];
    p->sk[i] = strides[4 + i];
    p->sv[i] = strides[8 + i];
    p->sg[i] = strides[12 + i];
    p->sb[i] = strides[16 + i];
    p->sdk[i] = strides[24 + i];
    p->sdv[i] = strides[28 + i];
  }
  p->causal = causal;
  const bool d4 = D % 4 == 0;
  p->vq = d4 && rows_of_4(q, p->sq, dtype);
  p->vk = d4 && rows_of_4(k, p->sk, dtype);
  p->vv = d4 && rows_of_4(v, p->sv, dtype);
  p->vg = d4 && rows_of_4(g, p->sg, dtype);
  p->vdk = d4 && rows_of_4(dk, p->sdk, dtype);
  p->vdv = d4 && rows_of_4(dv, p->sdv, dtype);
  p->s.D = D;
  p->s.dp = (D + 3) / 4 * 4;
  p->s.ld = p->s.dp + 4;
  // a k tile owns 4x4 output blocks (ceil(rows/4) * dp/4 of them), which
  // must fit kAccTiles per thread
  const int cap = D <= 64 ? 80 : 32;
  balanced_tiles(Tq, cap, &p->bq, &p->nq);
  balanced_tiles(Tk, cap, &p->bk, &p->nk);
  if ((p->bq + 3) / 4 * (p->s.dp / 4) > kAccTiles * kThreads ||
      (p->bk + 3) / 4 * (p->s.dp / 4) > kAccTiles * kThreads)
    return false;
  if ((int64_t)B * H * (p->nq > p->nk ? p->nq : p->nk) > 0x7fffffffLL)
    return false;
  return true;
}

}  // namespace

extern "C" {

int t2o_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                           const float* bias, const void* g, const float* m,
                           const float* l, const float* delta, void* dk,
                           void* dv, int B, int H, int Tq, int Tk, int D,
                           const int64_t* strides, int causal, void* stream);
int t2o_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                          const float* bias, const void* g, const float* m,
                          const float* l, const float* delta, void* dq, int B,
                          int H, int Tq, int Tk, int D, const int64_t* strides,
                          int causal, void* stream);
int t2o_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                         const float* bias, const void* g, const float* m,
                         const float* l, const float* delta, void* dq, int B,
                         int H, int Tq, int Tk, int D, const int64_t* strides,
                         int causal, void* stream);

// K2: dq. dtype 0 = float32, 1 = bfloat16; q, k, v, dO and dq share it.
// Both run the tensor-core bodies of flash_bwd_dq_tc.cu. Returns a
// cudaError_t code (0 = launched).
int t2o_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const float* bias, const void* g, const float* m,
                     const float* l, const float* delta, void* dq, int dtype,
                     int B, int H, int Tq, int Tk, int D,
                     const int64_t* strides, int causal, void* stream) {
  if (!valid_shape(dtype, B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  return (dtype == 0 ? t2o_flash_bwd_dq_f32 : t2o_flash_bwd_dq_bf16)(
      q, k, v, bias, g, m, l, delta, dq, B, H, Tq, Tk, D, strides, causal,
      stream);
}

// K3: dk and dv, as K2.
int t2o_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const float* bias, const void* g, const float* m,
                      const float* l, const float* delta, void* dk, void* dv,
                      int dtype, int B, int H, int Tq, int Tk, int D,
                      const int64_t* strides, int causal, void* stream) {
  BwdParams p;
  if (!make_params(&p, q, k, v, bias, g, m, l, delta, dk, dv, dtype, B, H,
                   Tq, Tk, D, strides, causal))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return t2o_flash_bwd_dkv_bf16(q, k, v, bias, g, m, l, delta, dk, dv, B, H,
                                  Tq, Tk, D, strides, causal, stream);
  return (int)launch_dkv<float>(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
