// Flash-attention dK/dV backward (K3), f32, on Hopper's tensor cores
// (sm_90a) as 3xTF32 on mma.sync m16n8k8.
//
// Replaces, for f32 inputs, the TPU kernel `_flash_attention_bwd_dkv_kernel`
// (t2omca_tpu/kernels/attention.py:253, launched at :464).
// t2o_flash_bwd_dkv (flash_bwd.cu) validates the arguments and calls this
// file for dtype 0; the bf16 body is flash_bwd_tc.cu. Per (b, h) and key
// tile, looping over the query tiles, it recomputes with the forward's
// semantics (replacement mask, causal -1e9, P from the residuals m and l of
// K1 + residuals):
//
//   S^T = K Q^T,  P^T = exp(S^T - m) / l,  dP^T = V dO^T,
//   dS^T = P^T o (dP^T - Delta), zeroed where the forward replaced the logit
//   dV += P^T dO  (the full P)         dK += dS^T Q
//
// with Delta = rowsum(dO o O) from the caller's torch reduction. dk and dv
// are written separately, in f32 (autograd sums them when k is v).
//
// Bound on this card: bytes at the learner's agent shape (2048, 1, 4, 65,
// 256: k, v, dk and dv are ~545 MB, 0.17 ms) and operations at the mixer
// shape (32, 1, 268, 131, 256: 24 B H Tq Tk D tf32 FLOPs for the four
// products as 3xTF32, 0.014 ms). The design:
//
// * 3xTF32 as in the f32 K1 and K2 (flash_mma.cuh): each operand split
//   into big and small tf32 parts, three tf32 products summed in f32, each
//   k8 group of S^T and dP^T accumulated into fresh registers and each
//   16-query step of dV and dK too (the tensor cores truncate a chained
//   f32 sum).
// * One CTA per (b, h) and balanced tile of at most 16 keys: no atomics,
//   deterministic sums. K and V are staged once per CTA (once when they are
//   one tensor); the 16-query tiles of Q, dO, m, l and Delta stream through
//   a two-stage cp.async ring when there is more than one.
// * The warps split D (64 columns each, four at D = 256): warp w sums S^T
//   and dP^T over its columns, and owns the same columns of dK and dV, so
//   it reads only its own columns of K, V, Q and dO. The partial 16 x 16
//   tiles meet in shared memory; every warp sums all of them in the same
//   order and reads them back directly as the A operands of P^T dO and
//   dS^T Q (keys as rows), forming P^T and dS^T itself. Every warp
//   computing S^T and dP^T over the whole of D instead (as the bf16 body
//   does) would make three of every four of those products redundant and
//   split every K, V, Q and dO element four times (the f32 K2 ran slower
//   that way; PERF.md, section 6).
// * Those A operands take k = t as query 2t and k = t + 4 as query 2t + 1,
//   so the B operands of dO and Q are rows 2t and 2t + 1 of the staged
//   tile at column g. Shared f32 rows are padded by 4 floats, which puts
//   those loads, and the scalar loads of K, V, Q and dO for S^T and dP^T
//   (row g, column t), on 32 distinct banks; the partial tiles' rows are
//   padded to 24 floats for the same reason.
// * The agent shape runs 5 CTAs of 13 keys per b (10240 CTAs of 4 warps,
//   one query step each), the mixer shape 9 CTAs of 15 keys per b (288 CTAs
//   of 4 warps, 17 query steps each); at D = 256 a CTA holds 112 KB of
//   shared memory, two an SM (62 KB and three at the agent shape with k is
//   v, the query-slice call).
// * dK and dV leave through shared memory (each warp's own columns of the
//   finished K tile) in 16-byte stores where the rows allow them.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2o;

constexpr int kBQ = 16;          // queries per step
constexpr int kBK = 16;          // keys per CTA (one warp tile)
constexpr int kPld = 24;         // row of a partial S^T / dP^T tile (f32)

struct Dkv32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* g;       // dO
  const float* bias;    // nullptr = no mask; else (B, H, Tq, Tk) by strides
  const float* m;       // (B, H, Tq) contiguous: residuals of K1
  const float* l;
  const float* delta;   // (B, H, Tq) contiguous: rowsum(dO o O)
  float* dk;
  float* dv;
  int B, H, Tq, Tk, D;
  int64_t sq[4], sk[4], sv[4], sg[4], sb[4], sdk[4], sdv[4];
  int causal;
  int bk, nk;           // keys per tile (<= kBK), key tiles per (b, h)
  int nq;               // query steps per (b, h)
  int vq, vk, vv, vg, vdk, vdv;
  int kv_same;
};

template <int DP>
struct Dkv32Shape {
  static constexpr int kSplit = DP >= 64 ? DP / 64 : 1;  // warps a CTA
  static constexpr int kDW = DP / kSplit;                // columns a warp
  static constexpr int kLd = DP + 4;                     // shared row
  static constexpr int kStages = 2;                      // Q/dO ring depth
};

// Registers: at most 168 a thread at D = 256, so that three CTAs fit an SM
// where shared memory allows them (the agent shape with k is v: 62 KB,
// 0.28 ms against 0.36 uncapped on the H100); ptxas spills nothing under
// that cap (scripts/torch_kernel_variants.py times the alternatives).
template <int DP>
__global__ void __launch_bounds__(Dkv32Shape<DP>::kSplit * 32, 3)
flash_bwd_dkv_3xtf32_kernel(const Dkv32Params p) {
  using Shape = Dkv32Shape<DP>;
  constexpr int LD = Shape::kLd, DW = Shape::kDW, W = Shape::kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = p.kv_same ? k_s : k_s + kBK * LD;
  float* ring = k_s + (p.kv_same ? 1 : 2) * kBK * LD;
  const int stages = min(Shape::kStages, p.nq);
  float* part = ring + stages * 2 * kBQ * LD;   // W x {S^T, dP^T} x 16 x kPld
  float* stats = part + W * 2 * kBK * kPld;     // stages x {m, l, Delta}

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int dh = tid >> 5, lane = tid & 31;   // warp = column block of D
  const int g = lane >> 2, t = lane & 3;
  const int c0 = dh * DW;

  int cell = blockIdx.x;
  const int kt = cell % p.nk;
  cell /= p.nk;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int k0 = kt * p.bk;
  const int kcols = min(p.bk, p.Tk - k0);

  const float* q = p.q + b * p.sq[0] + h * p.sq[1];
  const float* gr = p.g + b * p.sg[0] + h * p.sg[1];
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
    float* qs = ring + (j % stages) * 2 * kBQ * LD;
    stage_rows(qs, LD, q + (int64_t)q0 * p.sq[2], p.sq[2], p.sq[3], qv, kBQ,
               p.D, DP, p.vq, tid, nthreads);
    stage_rows(qs + kBQ * LD, LD, gr + (int64_t)q0 * p.sg[2], p.sg[2],
               p.sg[3], qv, kBQ, p.D, DP, p.vg, tid, nthreads);
    float* st = stats + (j % stages) * 3 * kBQ;
    for (int i = tid; i < 3 * kBQ; i += nthreads) {
      const int which = i / kBQ, r = i - which * kBQ;
      const float* src = which == 0 ? p.m : which == 1 ? p.l : p.delta;
      st[i] = r < qv ? src[row_base + q0 + r] : (which == 1 ? 1.f : 0.f);
    }
  };
  // steps 0 .. kStages - 2 in flight; one commit group a step (empty past
  // the last), so "step j has landed" is always wait<kStages - 2>
#pragma unroll
  for (int j = 0; j < Shape::kStages - 1; ++j) {
    if (j < p.nq) load_q(j);
    cp_async_commit();
  }

  float acc_k[DW / 8][4], acc_v[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }
  float* ps = part + dh * 2 * kBK * kPld;     // this warp's partial S^T
  float* pd = ps + kBK * kPld;                // and dP^T

  for (int j = 0; j < p.nq; ++j) {
    cp_async_wait<Shape::kStages - 2>();
    __syncthreads();   // step j has landed; every warp is done with j - 1
    if (j + Shape::kStages - 1 < p.nq)
      load_q(j + Shape::kStages - 1);   // into the stage step j - 1 used
    cp_async_commit();
    const float* qs = ring + (j % stages) * 2 * kBQ * LD;
    const float* gs = qs + kBQ * LD;
    const float* ms = stats + (j % stages) * 3 * kBQ;
    const float* ls = ms + kBQ;
    const float* ds = ls + kBQ;
    const int q0 = j * kBQ;
    const int qv = min(kBQ, p.Tq - q0);

    // partial S^T = K Q^T and dP^T = V dO^T over this warp's columns:
    // 16 keys x 16 queries each, each k8 group in fresh registers
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = 0.f;
        dpt[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < DW / 8; ++kk) {
      const int c = c0 + 8 * kk + t;
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (g + 8 * (e & 1)) * LD + c + 4 * (e >> 1);
        split_tf32(k_s[at], kb[e], ksm[e]);
        split_tf32(v_s[at], vb[e], vsm[e]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n * 8 < qv) {
          const int at = (8 * n + g) * LD + c;
          uint32_t b0, b1, s0, s1;
          float ts[4] = {0.f, 0.f, 0.f, 0.f}, tp[4] = {0.f, 0.f, 0.f, 0.f};
          split_tf32(qs[at], b0, s0);
          split_tf32(qs[at + 4], b1, s1);
          mma_3xtf32(ts, kb, ksm, b0, b1, s0, s1);
          split_tf32(gs[at], b0, s0);
          split_tf32(gs[at + 4], b1, s1);
          mma_3xtf32(tp, vb, vsm, b0, b1, s0, s1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[n][e] += ts[e];
            dpt[n][e] += tp[e];
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (g + 8 * r) * kPld + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(ps + at) =
            make_float2(st[n][2 * r], st[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pd + at) =
            make_float2(dpt[n][2 * r], dpt[n][2 * r + 1]);
      }
    __syncthreads();   // every warp's partials are in

    // P^T and dS^T in the tf32 A layout of the two 8-query blocks: keys g
    // and g + 8 as rows, k = t as query 2t and k = t + 4 as query 2t + 1,
    // summed over the warps' partials in one order
    uint32_t pb[2][4], psm[2][4], db[2][4], dsm[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ki = g + 8 * r;
        const int qi = 8 * kk + 2 * t;
        float2 sv = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float* pw = part + w * 2 * kBK * kPld + ki * kPld + qi;
          const float2 a = *reinterpret_cast<const float2*>(pw);
          const float2 c = *reinterpret_cast<const float2*>(pw + kBK * kPld);
          sv.x += a.x;
          sv.y += a.y;
          dv.x += c.x;
          dv.y += c.y;
        }
        const float svals[2] = {sv.x, sv.y}, dvals[2] = {dv.x, dv.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qe = qi + e;            // query of the tile
          const int key = k0 + ki;
          const int qrow = q0 + qe;
          float pv = 0.f, dsv = 0.f;
          if (qe < qv && ki < kcols) {
            float x = svals[e];
            bool replaced = false;
            if (bias != nullptr) {
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
            pv = expf(x - ms[qe]) / ls[qe];
            dsv = replaced ? 0.f : pv * (dvals[e] - ds[qe]);
          }
          // A word r + 2e: rows g (r = 0) and g + 8 (r = 1), k = t (e = 0)
          // and k = t + 4 (e = 1)
          split_tf32(pv, pb[kk][r + 2 * e], psm[kk][r + 2 * e]);
          split_tf32(dsv, db[kk][r + 2 * e], dsm[kk][r + 2 * e]);
        }
      }

    // dV += P^T dO and dK += dS^T Q on this warp's columns
#pragma unroll
    for (int nd = 0; nd < DW / 8; ++nd) {
      float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk * 8 < qv) {
          const int at = (8 * kk + 2 * t) * LD + c0 + 8 * nd + g;
          uint32_t b0, b1, s0, s1;
          split_tf32(gs[at], b0, s0);
          split_tf32(gs[at + LD], b1, s1);
          mma_3xtf32(tv, pb[kk], psm[kk], b0, b1, s0, s1);
          split_tf32(qs[at], b0, s0);
          split_tf32(qs[at + LD], b1, s1);
          mma_3xtf32(tk, db[kk], dsm[kk], b0, b1, s0, s1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_v[nd][e] += tv[e];
        acc_k[nd][e] += tk[e];
      }
    }
  }

  // dK, then dV, staged in this warp's own columns of the finished K tile
  // (no other warp reads them)
  float* blk = k_s + c0;
  __syncwarp();
  stage_frag(blk, LD, acc_k, g, t);
  __syncwarp();
  store_block(p.dk + b * p.sdk[0] + h * p.sdk[1] + (int64_t)k0 * p.sdk[2],
              p.sdk[2], p.sdk[3], blk, LD, kcols, c0, DW, p.D, p.vdk, lane);
  __syncwarp();
  stage_frag(blk, LD, acc_v, g, t);
  __syncwarp();
  store_block(p.dv + b * p.sdv[0] + h * p.sdv[1] + (int64_t)k0 * p.sdv[2],
              p.sdv[2], p.sdv[3], blk, LD, kcols, c0, DW, p.D, p.vdv, lane);
}

template <int DP>
cudaError_t launch(const Dkv32Params& p, cudaStream_t stream) {
  using Shape = Dkv32Shape<DP>;
  const int stages = min(Shape::kStages, p.nq);
  const size_t smem =
      sizeof(float) *
      ((size_t)Shape::kLd *
           ((p.kv_same ? 1 : 2) * (size_t)kBK + (size_t)stages * 2 * kBQ) +
       (size_t)Shape::kSplit * 2 * kBK * kPld + (size_t)stages * 3 * kBQ);
  auto kernel = flash_bwd_dkv_3xtf32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nk;
  kernel<<<(unsigned)grid, Shape::kSplit * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 for f32 q, k, v, dO, dk, dv; arguments as t2o_flash_bwd_dkv
// (flash_bwd.cu), which validates them and calls this for dtype 0.
int t2o_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                          const float* bias, const void* g, const float* m,
                          const float* l, const float* delta, void* dk,
                          void* dv, int B, int H, int Tq, int Tk, int D,
                          const int64_t* strides, int causal, void* stream) {
  Dkv32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.bias = bias;
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  auto rows_ok = [D](const void* ptr, const int64_t* s) {
    return D % 4 == 0 && rows_of_4(ptr, s, 0);
  };
  p.vq = rows_ok(q, p.sq);
  p.vk = rows_ok(k, p.sk);
  p.vv = rows_ok(v, p.sv);
  p.vg = rows_ok(g, p.sg);
  p.vdk = rows_ok(dk, p.sdk);
  p.vdv = rows_ok(dv, p.sdv);
  balanced_tiles(Tk, kBK, &p.bk, &p.nk);
  p.nq = (Tq + kBQ - 1) / kBQ;
  if ((int64_t)B * H * p.nk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
