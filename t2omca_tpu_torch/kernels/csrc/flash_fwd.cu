// Flash-attention forward for Hopper (sm_90a): the C entry point only.
// It validates the arguments and sends each dtype to its tensor-core body:
//
//   f32   flash_fwd_dmma.cu    (f64 on the FP64 tensor cores, mma.sync
//                              m16n8k4)
//   bf16  flash_fwd_tc.cu      (bf16 on mma.sync m16n8k16)
//
// Both replace the TPU kernel `_flash_attention_kernel`
// (t2omca_tpu/kernels/attention.py:115) in both of its launches by
// `_build.forward`: K1 at :392 (save_res=False, the serve path and the
// learner's no-grad target unrolls) and K1 + residuals at :383
// (save_res=True, the learner's online unrolls under autograd), which
// also writes each row's final running max m and denominator l, the
// residuals the backward kernels recompute P from. Per (batch b, head h):
//
//   S = Q K^T                                     (f32 accumulation)
//   S[i,j] = bias[i,j]        where bias[i,j] != 0  (REPLACEMENT mask)
//   S[i,j] = -1e9             where causal and j > i
//   O = softmax_rows(S) V      online softmax, f32 running max / sum / acc
//
// with the TPU kernel's exact semantics: the mask overwrites the logit (it
// is not added), causal positions take the same finite -1e9, the running
// max starts at -1e30 and key-tail padding never enters a row, so an
// all-masked row is the uniform mean of the REAL values. The output is
// cast to the input dtype (f32 or bf16).

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

int t2o_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* m, float* l, int B,
                       int H, int Tq, int Tk, int D, const int64_t* strides,
                       int causal, void* stream);
int t2o_flash_fwd_f32(const void* q, const void* k, const void* v,
                      const float* bias, void* o, float* m, float* l, int B,
                      int H, int Tq, int Tk, int D, const int64_t* strides,
                      int causal, void* stream);

// dtype: 0 = float32, 1 = bfloat16. strides: 20 int64 in elements, four
// each for q, k, v, bias, o over (B, H, T, D) resp. (B, H, Tq, Tk); the
// bias strides are ignored when bias is null. m and l: null, or both
// (B, H, Tq) contiguous f32 outputs of the residuals. Returns a cudaError_t
// code (0 = launched); cudaErrorInvalidValue for shapes the kernel does not
// take.
int t2o_flash_fwd(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* m, float* l, int dtype,
                  int B, int H, int Tq, int Tk, int D, const int64_t* strides,
                  int causal, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 256 ||
      (dtype != 0 && dtype != 1) || ((m == nullptr) != (l == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (dtype == 0 ? t2o_flash_fwd_f32 : t2o_flash_fwd_bf16)(
      q, k, v, bias, o, m, l, B, H, Tq, Tk, D, strides, causal, stream);
}

const char* t2o_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
