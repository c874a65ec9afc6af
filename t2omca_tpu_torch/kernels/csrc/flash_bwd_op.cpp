// PyTorch binding of the flash backward kernels as the custom ops
// `torch.ops.t2omca.flash_bwd_dq` (K2) and `torch.ops.t2omca.flash_bwd_dkv`
// (K3), registered as a fragment of the `t2omca` library that
// flash_fwd_op.cpp defines. Like that file, it keeps PyTorch's headers out
// of nvcc's way: flash_bwd.cu has a plain C interface.
//
// The caller (kernels/attention.py) allocates the gradients, expands the
// bias plane to (B, H, Tq, Tk), computes Delta = rowsum(dO o O) in f32 and
// passes the current CUDA stream as an integer; this file checks what the
// kernels rely on and launches.

#include <ATen/core/Tensor.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>

extern "C" int t2o_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const float* bias, const void* g,
                                const float* m, const float* l,
                                const float* delta, void* dq, int dtype,
                                int B, int H, int Tq, int Tk, int D,
                                const int64_t* strides, int causal,
                                void* stream);
extern "C" int t2o_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const float* bias, const void* g,
                                 const float* m, const float* l,
                                 const float* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int Tq, int Tk,
                                 int D, const int64_t* strides, int causal,
                                 void* stream);
extern "C" const char* t2o_cuda_error_string(int code);

namespace {

struct Checked {
  int dtype;
  int B, H, Tq, Tk, D;
  int64_t strides[32];
  const float* bias;
};

// Checks shared by K2 and K3; fills the strides of q, k, v, dO and bias
// (the output strides are the caller's).
Checked check(const char* op, const at::Tensor& q, const at::Tensor& k,
              const at::Tensor& v, const std::optional<at::Tensor>& bias,
              const at::Tensor& g, const at::Tensor& m, const at::Tensor& l,
              const at::Tensor& delta) {
  for (const at::Tensor* t : {&q, &k, &v, &g}) {
    TORCH_CHECK(t->is_cuda() && t->dim() == 4, op,
                ": q, k, v and dO must be 4-D CUDA tensors");
    TORCH_CHECK(t->device() == q.device(), op,
                ": q, k, v and dO must be on one device");
  }
  const auto st = q.scalar_type();
  TORCH_CHECK(st == at::ScalarType::Float || st == at::ScalarType::BFloat16,
              op, ": q must be float32 or bfloat16, got ", st);
  TORCH_CHECK(k.scalar_type() == st && v.scalar_type() == st &&
                  g.scalar_type() == st,
              op, ": q, k, v and dO must share one dtype");
  Checked c;
  c.dtype = st == at::ScalarType::Float ? 0 : 1;
  c.B = static_cast<int>(q.size(0));
  c.H = static_cast<int>(q.size(1));
  c.Tq = static_cast<int>(q.size(2));
  c.D = static_cast<int>(q.size(3));
  c.Tk = static_cast<int>(k.size(2));
  TORCH_CHECK(k.size(0) == c.B && k.size(1) == c.H && k.size(3) == c.D, op,
              ": k must be (B, H, Tk, D) matching q");
  TORCH_CHECK(v.sizes() == k.sizes(), op, ": v must match k");
  TORCH_CHECK(g.sizes() == q.sizes(), op, ": dO must match q");
  TORCH_CHECK(c.D >= 1 && c.D <= 256, op, ": head dim must be 1..256, got ",
              c.D);
  for (const at::Tensor* t : {&m, &l, &delta}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device() &&
                    t->scalar_type() == at::ScalarType::Float &&
                    t->dim() == 3 && t->size(0) == c.B &&
                    t->size(1) == c.H && t->size(2) == c.Tq &&
                    t->is_contiguous(),
                op, ": m, l and delta must be contiguous f32 (B, H, Tq) "
                    "on q's device");
  }
  for (int i = 0; i < 32; ++i) c.strides[i] = 0;
  for (int i = 0; i < 4; ++i) {
    c.strides[i] = q.stride(i);
    c.strides[4 + i] = k.stride(i);
    c.strides[8 + i] = v.stride(i);
    c.strides[12 + i] = g.stride(i);
  }
  c.bias = nullptr;
  if (bias.has_value()) {
    const at::Tensor& b = *bias;
    TORCH_CHECK(b.is_cuda() && b.device() == q.device() && b.dim() == 4 &&
                    b.scalar_type() == at::ScalarType::Float,
                op, ": bias must be a 4-D f32 tensor on q's device");
    TORCH_CHECK(b.size(0) == c.B && b.size(1) == c.H && b.size(2) == c.Tq &&
                    b.size(3) == c.Tk,
                op, ": bias must be expanded to (B, H, Tq, Tk)");
    for (int i = 0; i < 4; ++i) c.strides[16 + i] = b.stride(i);
    c.bias = b.const_data_ptr<float>();
  }
  return c;
}

void check_out(const char* op, const at::Tensor& out, const at::Tensor& like,
               const char* name) {
  TORCH_CHECK(out.is_cuda() && out.device() == like.device() &&
                  out.scalar_type() == like.scalar_type() &&
                  out.sizes() == like.sizes(),
              op, ": ", name, " must match its input's shape, dtype and "
                  "device");
}

void flash_bwd_dq(const at::Tensor& q, const at::Tensor& k,
                  const at::Tensor& v, const std::optional<at::Tensor>& bias,
                  const at::Tensor& g, const at::Tensor& m,
                  const at::Tensor& l, const at::Tensor& delta, bool causal,
                  int64_t stream, at::Tensor& dq) {
  Checked c = check("flash_bwd_dq", q, k, v, bias, g, m, l, delta);
  check_out("flash_bwd_dq", dq, q, "dq");
  for (int i = 0; i < 4; ++i) c.strides[20 + i] = dq.stride(i);
  const int code = t2o_flash_bwd_dq(
      q.const_data_ptr(), k.const_data_ptr(), v.const_data_ptr(), c.bias,
      g.const_data_ptr(), m.const_data_ptr<float>(), l.const_data_ptr<float>(),
      delta.const_data_ptr<float>(), dq.mutable_data_ptr(), c.dtype, c.B,
      c.H, c.Tq, c.Tk, c.D, c.strides, causal ? 1 : 0,
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(code == 0, "flash_bwd_dq: kernel launch failed: ",
              t2o_cuda_error_string(code));
}

void flash_bwd_dkv(const at::Tensor& q, const at::Tensor& k,
                   const at::Tensor& v, const std::optional<at::Tensor>& bias,
                   const at::Tensor& g, const at::Tensor& m,
                   const at::Tensor& l, const at::Tensor& delta, bool causal,
                   int64_t stream, at::Tensor& dk, at::Tensor& dv) {
  Checked c = check("flash_bwd_dkv", q, k, v, bias, g, m, l, delta);
  check_out("flash_bwd_dkv", dk, k, "dk");
  check_out("flash_bwd_dkv", dv, v, "dv");
  for (int i = 0; i < 4; ++i) {
    c.strides[24 + i] = dk.stride(i);
    c.strides[28 + i] = dv.stride(i);
  }
  const int code = t2o_flash_bwd_dkv(
      q.const_data_ptr(), k.const_data_ptr(), v.const_data_ptr(), c.bias,
      g.const_data_ptr(), m.const_data_ptr<float>(), l.const_data_ptr<float>(),
      delta.const_data_ptr<float>(), dk.mutable_data_ptr(),
      dv.mutable_data_ptr(), c.dtype, c.B, c.H, c.Tq, c.Tk, c.D, c.strides,
      causal ? 1 : 0, reinterpret_cast<void*>(stream));
  TORCH_CHECK(code == 0, "flash_bwd_dkv: kernel launch failed: ",
              t2o_cuda_error_string(code));
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(t2omca, m) {
  m.def(
      "flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor g, "
      "Tensor m, Tensor l, Tensor delta, bool causal, int stream, "
      "Tensor(a!) dq) -> ()");
  m.def(
      "flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor g, "
      "Tensor m, Tensor l, Tensor delta, bool causal, int stream, "
      "Tensor(a!) dk, Tensor(b!) dv) -> ()");
}

TORCH_LIBRARY_IMPL(t2omca, CUDA, m) {
  m.impl("flash_bwd_dq", &flash_bwd_dq);
  m.impl("flash_bwd_dkv", &flash_bwd_dkv);
}
