// Flash-attention backward for Hopper (sm_90a): the C entry points of K2
// and K3 only. They validate the arguments and send each dtype to its
// tensor-core body:
//
//   K2 (dq), f32 and bf16    flash_bwd_dq_tc.cu (bf16 on mma.sync
//                            m16n8k16; f32 as 3xTF32 on m16n8k8)
//   K3 (dk, dv), bf16        flash_bwd_tc.cu (m16n8k16)
//   K3 (dk, dv), f32         flash_bwd_dkv_3xtf32.cu (3xTF32 on m16n8k8)
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
// accumulates in f32; dq, dk, dv are written in the input dtype. No CTA
// needs another's result: K3's CTAs own their keys and loop over the
// query tiles in place of the TPU's sequential grid axis (:270-297), so no
// atomics are needed and the sums are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Do the kernels take these sizes and this dtype code?
bool valid_shape(int dtype, int B, int H, int Tq, int Tk, int D) {
  return B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && D >= 1 && D <= 256 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

int t2o_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                           const float* bias, const void* g, const float* m,
                           const float* l, const float* delta, void* dk,
                           void* dv, int B, int H, int Tq, int Tk, int D,
                           const int64_t* strides, int causal, void* stream);
int t2o_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
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

// K3: dk and dv, as K2; f32 runs flash_bwd_dkv_3xtf32.cu, bf16
// flash_bwd_tc.cu. strides: 32 int64 in elements, four each for q, k, v,
// dO, bias, dq, dk, dv; the bias strides are ignored when bias is null, and
// dq's too.
int t2o_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const float* bias, const void* g, const float* m,
                      const float* l, const float* delta, void* dk, void* dv,
                      int dtype, int B, int H, int Tq, int Tk, int D,
                      const int64_t* strides, int causal, void* stream) {
  if (!valid_shape(dtype, B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  return (dtype == 0 ? t2o_flash_bwd_dkv_f32 : t2o_flash_bwd_dkv_bf16)(
      q, k, v, bias, g, m, l, delta, dk, dv, B, H, Tq, Tk, D, strides, causal,
      stream);
}

}  // extern "C"
