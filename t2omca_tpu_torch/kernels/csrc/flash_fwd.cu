// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++:
// the f32 body on the CUDA cores. bf16 inputs go to the tensor-core body
// of flash_fwd_tc.cu (t2o_flash_fwd below dispatches on the dtype).
//
// Replaces the TPU kernel `_flash_attention_kernel`
// (t2omca_tpu/kernels/attention.py:115), both of its launches by
// `_build.forward`: K1 at :392 (save_res=False, the serve path and the
// learner's no-grad target unrolls) and K1 + residuals at :383
// (save_res=True, the learner's online unrolls under autograd), which
// also writes each row's final running max m and denominator l, the
// residuals the backward kernels (flash_bwd.cu) recompute P from.
// Computes, per (batch b, head h):
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
//
// Bound on this card: at the serve shape (B=4096, H=4, T=65, D=64) the
// four tensors move ~1.09 GB at f32 against ~17.7 GFLOP, so the function
// is bytes-bound (~0.33 ms at 3.35 TB/s). The products run on the CUDA
// cores in f32 (no tensor cores yet). Measured (PERF.md), this kernel is
// held back by latency: each CTA walks stage -> logits -> softmax -> PV
// with a barrier between phases, so the SM needs several CTAs in flight
// to overlap them. Register use therefore decides the speed: two CTAs
// per SM (128 registers) ran 1.5x faster than one (196 registers), and
// three (85 registers, with spills) ran slower again. The design:
//
// * One CTA of 256 threads per (b, h, q-tile), two CTAs per SM. A q-tile
//   holds up to 80 rows when D <= 64 (all 65 tokens of the agent in one
//   tile, so K and V are read from HBM once per (b, h)) and up to 32 rows
//   otherwise. Tiles are balanced (ceil division).
// * Q, then per key tile (up to 128 keys, 64 when D > 128) K and V, are
//   staged in shared memory as f32, rows padded to a multiple of 4 floats
//   plus 4 so that float4 loads of neighbouring rows hit distinct banks.
//   Each thread issues 4 row loads (16-byte or 8-byte vectors where the
//   layout allows) before it stores any, so their latencies overlap.
// * Logits: each thread computes 4x4 blocks of S whose rows and columns
//   are strided (r, r + R, r + 2R, ...), reading Q and K as float4 —
//   8 shared loads per 64 FMAs instead of 2 per FMA. Masks are applied as
//   the block is written to shared memory.
// * Online softmax, one warp per row, f32 running max / denominator.
// * P V: each thread owns up to two (4 rows x 4 columns) blocks of the
//   output in registers for the whole key loop; per key it reads 4 P
//   values and one float4 of V for 16 FMAs.
//
// Tensor cores for f32 (3xTF32 to keep the f32 tolerance) are later work;
// see PERF.md for times.

#include "flash_common.cuh"

namespace {

using namespace t2o;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // nullptr = no mask; else (B, H, Tq, Tk) by strides
  void* o;
  float* m;            // nullptr = no residuals; else (B, H, Tq) contiguous
  float* l;            // with m: the final running max and denominator
  int B, H, Tq, Tk, D;
  int64_t sq[4], sk[4], sv[4], sb[4], so[4];
  int causal;
  int bq;   // rows per q tile
  int bk;   // keys per k tile
  int nq;   // q tiles per (b, h)
  Slab g;   // staged slab geometry (D padded to dp, shared row stride ld)
  int vec;  // q, k, v, o rows load/store as aligned groups of 4 elements
};

// two CTAs per SM: registers capped at 128 per thread. Instantiated for
// float only: bf16 runs flash_fwd_tc.cu.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.g.ld;
  const int lds = p.bk + 1;            // row stride of the logits tile
  float* q_s = smem;                   // bq x ld
  float* k_s = q_s + p.bq * ld;        // bk x ld
  float* v_s = k_s + p.bk * ld;        // bk x ld
  float* s_s = v_s + p.bk * ld;        // bq x lds (logits, then P)
  float* m_s = s_s + p.bq * lds;       // bq running max
  float* l_s = m_s + p.bq;             // bq running denominator
  float* a_s = l_s + p.bq;             // bq rescale factor of this tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int cell = blockIdx.x;
  const int qt = cell % p.nq;
  cell /= p.nq;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int q0 = qt * p.bq;
  const int rows = min(p.bq, p.Tq - q0);

  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];

  stage(q_s, q + (int64_t)q0 * p.sq[2], p.sq[2], p.sq[3], rows, p.g,
        p.vec);
  for (int i = tid; i < rows; i += kThreads) {
    m_s[i] = kPad;
    l_s[i] = 0.f;
  }

  // output blocks owned by this thread: rows {rg + nrg*a}, columns
  // 4*ch .. 4*ch+3, for u = tid + kThreads*t, u < nrg * nch
  const int nrg = (rows + 3) / 4;
  const int nch = p.g.dp / 4;
  const int n_out = nrg * nch;
  float4 acc[kAccTiles][4];
#pragma unroll
  for (int t = 0; t < kAccTiles; ++t)
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[t][a] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_ktiles = (p.Tk + p.bk - 1) / p.bk;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * p.bk;
    const int kcols = min(p.bk, p.Tk - k0);
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage(k_s, k + (int64_t)k0 * p.sk[2], p.sk[2], p.sk[3], kcols, p.g,
          p.vec);
    stage(v_s, v + (int64_t)k0 * p.sv[2], p.sv[2], p.sv[3], kcols, p.g,
          p.vec);
    __syncthreads();

    // logits in 4x4 blocks with strided rows and columns. Key-tail
    // padding (cols >= Tk) is never written: its -1e30 fill on the TPU
    // contributes exp(-1e30 - m) == 0 to every row (m >= -1e9 after any
    // real column).
    const int ncg = (kcols + 3) / 4;
    for (int u = tid; u < nrg * ncg; u += kThreads) {
      const int rg = u / ncg, cg = u - rg * ncg;
      const float* qr[4];
      const float* kr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qr[a] = q_s + min(rg + nrg * a, rows - 1) * ld;
        kr[a] = k_s + min(cg + ncg * a, kcols - 1) * ld;
      }
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
      for (int d = 0; d < p.g.dp; d += 4) {
        float4 qf[4], kf[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qf[a] = *reinterpret_cast<const float4*>(qr[a] + d);
          kf[a] = *reinterpret_cast<const float4*>(kr[a] + d);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = dot4(qf[a], kf[c], s[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = rg + nrg * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = cg + ncg * c;
          if (i < rows && j < kcols) {
            float sv = s[a][c];
            const int row = q0 + i, col = k0 + j;
            if (bias != nullptr) {
              const float bb =
                  bias[(int64_t)row * p.sb[2] + (int64_t)col * p.sb[3]];
              if (bb != 0.f) sv = bb;
            }
            if (p.causal && col > row) sv = kNegMask;
            s_s[i * lds + j] = sv;
          }
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per row
    for (int i = warp; i < rows; i += kWarps) {
      float* sr = s_s + i * lds;
      float mx = kPad;
      for (int j = lane; j < kcols; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kcols; j += 32) {
        const float e = expf(sr[j] - m_new);
        sr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V on the owned output blocks
#pragma unroll
    for (int t = 0; t < kAccTiles; ++t) {
      const int u = tid + t * kThreads;
      if (u < n_out) {
        const int rg = u / nch, ch = u - rg * nch;
        const float* pr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = min(rg + nrg * a, rows - 1);
          pr[a] = s_s + i * lds;
          const float al = a_s[i];
          acc[t][a].x *= al;
          acc[t][a].y *= al;
          acc[t][a].z *= al;
          acc[t][a].w *= al;
        }
        const float* vc = v_s + 4 * ch;
        for (int j = 0; j < kcols; ++j) {
          const float4 vf = *reinterpret_cast<const float4*>(vc + j * ld);
#pragma unroll
          for (int a = 0; a < 4; ++a) fma4(pr[a][j], vf, acc[t][a]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kAccTiles; ++t) {
    const int u = tid + t * kThreads;
    if (u < n_out) {
      const int rg = u / nch, ch = u - rg * nch;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = rg + nrg * a;
        if (i < rows) {
          const float l = l_s[i];
          const float4 r = make_float4(acc[t][a].x / l, acc[t][a].y / l,
                                       acc[t][a].z / l, acc[t][a].w / l);
          write4(o + (int64_t)(q0 + i) * p.so[2], p.so[3], 4 * ch, p.D, r,
                 p.vec);
        }
      }
    }
  }
  // K1 + residuals (save_res): the final per-row running max and
  // denominator, kept separate (never fused into a logsumexp: an
  // all-masked row has m = -1e9, which would swallow log l in f32)
  if (p.m != nullptr) {
    // (b, h) recomputed here rather than kept live across the key loop
    const int64_t base = (int64_t)(blockIdx.x / p.nq) * p.Tq + q0;
    for (int i = tid; i < rows; i += kThreads) {
      p.m[base + i] = m_s[i];
      p.l[base + i] = l_s[i];
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nq;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int t2o_flash_fwd_bf16(const void* q, const void* k, const void* v,
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
  if (dtype == 1)
    return t2o_flash_fwd_bf16(q, k, v, bias, o, m, l, B, H, Tq, Tk, D,
                              strides, causal, stream);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.o = o;
  p.m = m;
  p.l = l;
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.sb[i] = strides[12 + i];
    p.so[i] = strides[16 + i];
  }
  p.causal = causal;
  p.vec = D % 4 == 0 && rows_of_4(q, p.sq, 0) && rows_of_4(k, p.sk, 0) &&
          rows_of_4(v, p.sv, 0) && rows_of_4(o, p.so, 0);
  p.g.D = D;
  p.g.dp = (D + 3) / 4 * 4;
  p.g.ld = p.g.dp + 4;
  // q-tile rows: the owned output blocks (ceil(bq/4) * dp/4 of them) must
  // fit kAccTiles per thread
  balanced_tiles(Tq, D <= 64 ? 80 : 32, &p.bq, &p.nq);
  int nk;
  balanced_tiles(Tk, D <= 128 ? 128 : 64, &p.bk, &nk);
  if ((int64_t)B * H * p.nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((p.bq + 3) / 4 * (p.g.dp / 4) > kAccTiles * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)p.bq * p.g.ld + 2 * (size_t)p.bk * p.g.ld +
                       (size_t)p.bq * (p.bk + 1) + 3 * (size_t)p.bq);
  return (int)launch<float>(p, smem, static_cast<cudaStream_t>(stream));
}

const char* t2o_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
