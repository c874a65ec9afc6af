// PyTorch binding of dropout's keep-mask kernel (dropout_mask.cu) as the
// custom op `torch.ops.t2omca.dropout_mask`, loaded with
// torch.ops.load_library. The caller (kernels/dropout.py) allocates `out`
// and passes the current CUDA stream as an integer; this file checks what
// the kernel relies on and launches.

#include <ATen/core/Tensor.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <cstdint>

extern "C" int t2o_dropout_mask(const int64_t* key, uint32_t fold,
                                float keep, void* out, int64_t n,
                                void* stream);
extern "C" const char* t2o_cuda_error_string(int code);

namespace {

void dropout_mask(const at::Tensor& key, int64_t fold, double keep,
                  int64_t stream, at::Tensor& out) {
  TORCH_CHECK(key.is_cuda() && out.is_cuda() &&
                  key.device() == out.device(),
              "dropout_mask: key and out must be on one CUDA device");
  TORCH_CHECK(key.scalar_type() == at::ScalarType::Long &&
                  key.numel() == 2 && key.is_contiguous(),
              "dropout_mask: key must be a contiguous int64 (2,) tensor");
  TORCH_CHECK(out.scalar_type() == at::ScalarType::Bool &&
                  out.is_contiguous(),
              "dropout_mask: out must be a contiguous bool tensor");
  TORCH_CHECK(fold >= 0 && fold < (int64_t(1) << 32),
              "dropout_mask: fold must be a uint32, got ", fold);
  TORCH_CHECK(out.numel() < (int64_t(1) << 32),
              "dropout_mask: draws of 2**32 or more elements");
  const int code = t2o_dropout_mask(
      key.const_data_ptr<int64_t>(), static_cast<uint32_t>(fold),
      static_cast<float>(keep),
      out.mutable_data_ptr(), out.numel(), reinterpret_cast<void*>(stream));
  TORCH_CHECK(code == 0, "dropout_mask: kernel launch failed: ",
              t2o_cuda_error_string(code));
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(t2omca, m) {
  m.def("dropout_mask(Tensor key, int fold, float keep, int stream, "
        "Tensor(a!) out) -> ()");
}

TORCH_LIBRARY_IMPL(t2omca, CUDA, m) { m.impl("dropout_mask", &dropout_mask); }
