// PyTorch binding of the flash forward kernel as the custom ops
// `torch.ops.t2omca.flash_fwd` (K1) and `torch.ops.t2omca.flash_fwd_res`
// (K1 + residuals: also the per-row m and l), loaded with
// torch.ops.load_library.
//
// Kept apart from flash_fwd.cu so that only this small host file sees
// PyTorch's headers (the host compiler handles them in seconds; nvcc takes
// minutes), and so that the kernel file has a plain C interface. The
// caller (kernels/attention.py) allocates `out`, expands the bias plane to
// (B, H, Tq, Tk) and passes the current CUDA stream as an integer; this
// file checks what the kernel relies on and launches.

#include <ATen/core/Tensor.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>

extern "C" int t2o_flash_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* o, float* m, float* l,
                             int dtype, int B, int H, int Tq, int Tk, int D,
                             const int64_t* strides, int causal,
                             void* stream);
extern "C" const char* t2o_cuda_error_string(int code);

namespace {

void check_4d(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), "flash_fwd: ", name, " must be a CUDA tensor");
  TORCH_CHECK(t.dim() == 4, "flash_fwd: ", name, " must be 4-D, got ",
              t.dim(), "-D");
}

void launch(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
            const std::optional<at::Tensor>& bias, bool causal,
            int64_t stream, at::Tensor& out, float* m, float* l) {
  check_4d(q, "q");
  check_4d(k, "k");
  check_4d(v, "v");
  check_4d(out, "out");
  const auto st = q.scalar_type();
  TORCH_CHECK(st == at::ScalarType::Float || st == at::ScalarType::BFloat16,
              "flash_fwd: q must be float32 or bfloat16, got ", st);
  TORCH_CHECK(k.scalar_type() == st && v.scalar_type() == st &&
                  out.scalar_type() == st,
              "flash_fwd: q, k, v and out must share one dtype");
  const int64_t B = q.size(0), H = q.size(1), Tq = q.size(2), D = q.size(3);
  const int64_t Tk = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(1) == H && k.size(3) == D,
              "flash_fwd: k must be (B, H, Tk, D) matching q");
  TORCH_CHECK(v.sizes() == k.sizes(), "flash_fwd: v must match k");
  TORCH_CHECK(out.sizes() == q.sizes(), "flash_fwd: out must match q");
  TORCH_CHECK(D >= 1 && D <= 256, "flash_fwd: head dim must be 1..256, got ",
              D);
  TORCH_CHECK(Tq >= 1 && Tk >= 1 && B >= 1 && H >= 1,
              "flash_fwd: empty attention");
  TORCH_CHECK(q.device() == k.device() && q.device() == v.device() &&
                  q.device() == out.device(),
              "flash_fwd: q, k, v and out must be on one device");

  int64_t strides[20] = {0};
  for (int i = 0; i < 4; ++i) {
    strides[i] = q.stride(i);
    strides[4 + i] = k.stride(i);
    strides[8 + i] = v.stride(i);
    strides[16 + i] = out.stride(i);
  }
  const float* bias_ptr = nullptr;
  if (bias.has_value()) {
    const at::Tensor& b = *bias;
    check_4d(b, "bias");
    TORCH_CHECK(b.scalar_type() == at::ScalarType::Float,
                "flash_fwd: bias must be float32");
    TORCH_CHECK(b.size(0) == B && b.size(1) == H && b.size(2) == Tq &&
                    b.size(3) == Tk,
                "flash_fwd: bias must be expanded to (B, H, Tq, Tk)");
    TORCH_CHECK(b.device() == q.device(),
                "flash_fwd: bias must be on q's device");
    for (int i = 0; i < 4; ++i) strides[12 + i] = b.stride(i);
    bias_ptr = b.const_data_ptr<float>();
  }
  const int code = t2o_flash_fwd(
      q.const_data_ptr(), k.const_data_ptr(), v.const_data_ptr(), bias_ptr,
      out.mutable_data_ptr(), m, l, st == at::ScalarType::Float ? 0 : 1,
      static_cast<int>(B), static_cast<int>(H), static_cast<int>(Tq),
      static_cast<int>(Tk), static_cast<int>(D), strides, causal ? 1 : 0,
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(code == 0, "flash_fwd: kernel launch failed: ",
              t2o_cuda_error_string(code));
}

void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const std::optional<at::Tensor>& bias, bool causal,
               int64_t stream, at::Tensor& out) {
  launch(q, k, v, bias, causal, stream, out, nullptr, nullptr);
}

void flash_fwd_res(const at::Tensor& q, const at::Tensor& k,
                   const at::Tensor& v, const std::optional<at::Tensor>& bias,
                   bool causal, int64_t stream, at::Tensor& out,
                   at::Tensor& m, at::Tensor& l) {
  for (const at::Tensor* t : {&m, &l}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device(),
                "flash_fwd_res: m and l must be on q's device");
    TORCH_CHECK(t->scalar_type() == at::ScalarType::Float,
                "flash_fwd_res: m and l must be float32");
    TORCH_CHECK(t->dim() == 3 && t->size(0) == q.size(0) &&
                    t->size(1) == q.size(1) && t->size(2) == q.size(2) &&
                    t->is_contiguous(),
                "flash_fwd_res: m and l must be contiguous (B, H, Tq)");
  }
  launch(q, k, v, bias, causal, stream, out, m.mutable_data_ptr<float>(),
         l.mutable_data_ptr<float>());
}

}  // namespace

TORCH_LIBRARY(t2omca, m) {
  m.def(
      "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? bias, bool causal, "
      "int stream, Tensor(a!) out) -> ()");
  m.def(
      "flash_fwd_res(Tensor q, Tensor k, Tensor v, Tensor? bias, "
      "bool causal, int stream, Tensor(a!) out, Tensor(b!) m, "
      "Tensor(c!) l) -> ()");
}

TORCH_LIBRARY_IMPL(t2omca, CUDA, m) {
  m.impl("flash_fwd", &flash_fwd);
  m.impl("flash_fwd_res", &flash_fwd_res);
}
