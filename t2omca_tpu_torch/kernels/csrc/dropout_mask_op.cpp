// PyTorch binding of dropout's keep-mask kernel (dropout_mask.cu) as the
// custom op `torch.ops.t2omca.dropout_mask`, loaded with
// torch.ops.load_library. The caller (kernels/dropout.py) allocates `out`
// and passes the current CUDA stream as an integer; this file checks what
// the kernel relies on and launches.

#include <ATen/core/Tensor.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>

extern "C" int t2o_dropout_mask(const int64_t* key, uint32_t fold,
                                float keep, void* out, int64_t n,
                                const int64_t* rows, int64_t row_elems,
                                void* stream);
extern "C" int t2o_dropout_mask_philox(const int64_t* key, uint32_t fold,
                                       int unsafe, const uint32_t* xor_words,
                                       float keep, void* out, int64_t n,
                                       const int64_t* rows,
                                       int64_t row_elems, void* stream);
extern "C" const char* t2o_cuda_error_string(int code);

namespace {

// The checks both paths share; → the row map's pointer (or null).
const int64_t* check_mask_args(const at::Tensor& key, int64_t words,
                               int64_t fold, at::Tensor& out,
                               const std::optional<at::Tensor>& rows,
                               int64_t row_elems) {
  TORCH_CHECK(key.is_cuda() && out.is_cuda() &&
                  key.device() == out.device(),
              "dropout_mask: key and out must be on one CUDA device");
  TORCH_CHECK(key.scalar_type() == at::ScalarType::Long &&
                  key.numel() == words && key.is_contiguous(),
              "dropout_mask: key must be a contiguous int64 (", words,
              ",) tensor");
  TORCH_CHECK(out.scalar_type() == at::ScalarType::Bool &&
                  out.is_contiguous(),
              "dropout_mask: out must be a contiguous bool tensor");
  TORCH_CHECK(fold >= 0 && fold < (int64_t(1) << 32),
              "dropout_mask: fold must be a uint32, got ", fold);
  TORCH_CHECK(out.numel() < (int64_t(1) << 32),
              "dropout_mask: draws of 2**32 or more elements");
  const int64_t* row_map = nullptr;
  if (rows.has_value()) {
    const at::Tensor& r = *rows;
    TORCH_CHECK(r.is_cuda() && r.device() == out.device() &&
                    r.scalar_type() == at::ScalarType::Long && r.dim() == 1 &&
                    r.is_contiguous(),
                "dropout_mask: rows must be a contiguous int64 1-D tensor on "
                "the key's device");
    TORCH_CHECK(row_elems > 0 && out.numel() == r.numel() * row_elems,
                "dropout_mask: out holds ", out.numel(), " elements, not ",
                r.numel(), " rows of ", row_elems);
    row_map = r.const_data_ptr<int64_t>();
  }
  return row_map;
}

void dropout_mask(const at::Tensor& key, int64_t fold, double keep,
                  int64_t stream, at::Tensor& out,
                  const std::optional<at::Tensor>& rows, int64_t row_elems) {
  const int64_t* row_map =
      check_mask_args(key, 2, fold, out, rows, row_elems);
  const int code = t2o_dropout_mask(
      key.const_data_ptr<int64_t>(), static_cast<uint32_t>(fold),
      static_cast<float>(keep), out.mutable_data_ptr(), out.numel(),
      row_map, row_elems, reinterpret_cast<void*>(stream));
  TORCH_CHECK(code == 0, "dropout_mask: kernel launch failed: ",
              t2o_cuda_error_string(code));
}

// xor_words: empty under rbg (the fold is threefry on each half), the 4
// uint32 words the key is xored with under unsafe_rbg.
void dropout_mask_philox(const at::Tensor& key, int64_t fold,
                         at::IntArrayRef xor_words, double keep,
                         int64_t stream, at::Tensor& out,
                         const std::optional<at::Tensor>& rows,
                         int64_t row_elems) {
  const int64_t* row_map =
      check_mask_args(key, 4, fold, out, rows, row_elems);
  TORCH_CHECK(xor_words.empty() || xor_words.size() == 4,
              "dropout_mask_philox: xor_words holds 0 or 4 words");
  uint32_t x[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < xor_words.size(); ++i) {
    TORCH_CHECK(xor_words[i] >= 0 && xor_words[i] < (int64_t(1) << 32),
                "dropout_mask_philox: xor words are uint32");
    x[i] = static_cast<uint32_t>(xor_words[i]);
  }
  const int code = t2o_dropout_mask_philox(
      key.const_data_ptr<int64_t>(), static_cast<uint32_t>(fold),
      xor_words.empty() ? 0 : 1, x, static_cast<float>(keep),
      out.mutable_data_ptr(), out.numel(), row_map, row_elems,
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(code == 0, "dropout_mask_philox: kernel launch failed: ",
              t2o_cuda_error_string(code));
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(t2omca, m) {
  m.def("dropout_mask(Tensor key, int fold, float keep, int stream, "
        "Tensor(a!) out, Tensor? rows, int row_elems) -> ()");
  m.def("dropout_mask_philox(Tensor key, int fold, int[] xor_words, "
        "float keep, int stream, Tensor(a!) out, Tensor? rows, "
        "int row_elems) -> ()");
}

TORCH_LIBRARY_IMPL(t2omca, CUDA, m) {
  m.impl("dropout_mask", &dropout_mask);
  m.impl("dropout_mask_philox", &dropout_mask_philox);
}
