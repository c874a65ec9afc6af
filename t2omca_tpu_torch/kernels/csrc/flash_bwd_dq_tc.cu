// Flash-attention dQ backward (K2) on Hopper's tensor cores (sm_90a): the
// bf16 body on mma.sync m16n8k16 (bf16 in, f32 accumulate) and the f32 body
// on mma.sync m16n8k8 with tf32 operands split 3xTF32. Both are in this
// file; t2o_flash_bwd_dq (flash_bwd.cu) validates the arguments and calls
// one of the two entry points at the end.
//
// Replaces the TPU kernel `_flash_attention_bwd_dq_kernel`
// (t2omca_tpu/kernels/attention.py:210, with `_recompute_p` :182, launched
// at :437). Per (b, h) and tile of 16 queries, looping over tiles of 16
// keys, it recomputes with the forward's semantics (replacement mask: a
// nonzero bias overwrites the logit; causal -1e9; P from the residuals m
// and l of K1 + residuals):
//
//   S = Q K^T,  P = exp(S - m) / l,  dP = dO V^T,
//   dS = P o (dP - Delta), zeroed where the forward replaced the logit
//   dQ += dS K
//
// with Delta = rowsum(dO o O) from the caller's torch reduction. dq is
// written in q's dtype, layout and strides.
//
// Edges, the same at both dtypes: key columns >= Tk give dS = 0 explicitly
// (a zero-filled K row gives S = 0, and exp(0 - m) / l is inf or > 1 where
// m is -1e9 or every logit is negative); query rows >= Tq take m = 0,
// l = 1, Delta = 0, read no bias and are never written; an all-masked row
// has every dS replaced, so its dq is exactly 0; D pads with zeros to a
// multiple of 16; rows that are not 16-byte aligned stage with scalar loads.
//
// Bound on this card: bytes at the learner shapes (K2 reads q, dO, k, v
// once and writes dq: ~100 MB at the agent shape (2048, 1, 4, 65, 256),
// against ~1 GFLOP). The design keeps the per-key-tile work on the tensor
// cores and the bytes in flight:
//
// * One CTA per (b, h, 16-query tile): Q, dO and the rows of m, l and Delta
//   are staged once; 16-key tiles of K and V stream through a two-stage
//   cp.async ring (K staged once when k is v, the query-slice call). Two
//   __syncthreads a key tile (one in the bf16 body at D <= 64). The agent shape runs 2048
//   CTAs of one tile (4 real rows) over 5 key tiles; the mixer shape
//   32 x 17 CTAs over 9.
// * Both bodies split D over the warps (64 columns each, four at D = 256):
//   warp w sums S and dP over its columns and owns the same columns of dQ.
//   The partial 16 x 16 tiles meet in shared memory, and every warp sums
//   all of them in the same order, so every warp forms the same dS.
//   (Every warp computing S and dP over the whole of D, as K3 does, made
//   three of every four of its mma redundant and ran slower on the card;
//   PERF.md, section 6.)
// * bf16: Q and dO are the A operands (ldmatrix), K and V the B operands
//   (ldmatrix). dS, rounded to bf16 in registers, is directly the A operand
//   of dS K (K through ldmatrix.trans): no transpose passes through shared
//   memory. The one new rounding against the TPU kernel: dS is bf16 in
//   dS K (JAX keeps it f32), as K3 rounds its dS for dS^T Q.
// * f32 (3xTF32): each operand x is split into big = tf32(x) and small =
//   tf32(x - big) (round to nearest, ties away) and each product
//   accumulates small*big + big*small, then big*big. The tensor cores'
//   f32 accumulation truncates, so a long chain of mma into one
//   accumulator drifts: in S and dP over D = 64 that missed the f32
//   tolerance (rtol 1e-4 / atol 1e-5) where dP - Delta cancels (causal
//   rows with few keys). Each k8 group therefore accumulates into fresh
//   registers that a rounded f32 add carries into the running sum, a
//   little slower and within the tolerance on the H100 (PERF.md,
//   section 6).
//   Every warp reads the summed S and dP back in the tf32 A layout (which
//   is not the C layout) and forms dS itself.
//   Each operand element is loaded and split once per CTA. f32 rows are
//   padded by 8 floats, so the 8-byte fragment loads (k permuted: k = t and
//   t+4 are columns 2t and 2t+1) and the strided B loads of K for dS K are
//   free of bank conflicts.
// * dq leaves through shared memory in 16-byte stores.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace t2o;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 16;          // queries per CTA (one mma row tile)
constexpr int kBK = 16;          // keys per step
constexpr int kPld = kBK + 4;    // row of a partial S / dP tile (f32)

template <typename T>
struct DqParams {
  const T* q;
  const T* k;
  const T* v;
  const T* g;           // dO
  const float* bias;    // nullptr = no mask; else (B, H, Tq, Tk) by strides
  const float* m;       // (B, H, Tq) contiguous: residuals of K1
  const float* l;
  const float* delta;   // (B, H, Tq) contiguous: rowsum(dO o O)
  T* dq;
  int B, H, Tq, Tk, D;
  int64_t sq[4], sk[4], sv[4], sg[4], sb[4], sdq[4];
  int causal;
  int nq, nk;           // query tiles and key steps per (b, h)
  int vq, vk, vv, vg, vdq;
  int kv_same;
};

template <int DP>
struct DqShape {
  static constexpr int kSplit = DP >= 64 ? DP / 64 : 1;  // warps a CTA
  static constexpr int kDW = DP / kSplit;                // columns a warp
  // shared rows padded by 8 elements: 16 bytes at bf16, 32 at f32
  static constexpr int kLd = DP + 8;
  // bf16: five 4-warp CTAs an SM at D = 256 (96 registers a thread, 32 of
  // them the accumulators), so the mixer shape's 544 CTAs run in one wave
  // on 132 SMs; a one-warp CTA may take more. f32: shared memory holds two
  // CTAs an SM at D = 256, so the cap is what that occupancy leaves.
  static constexpr int kMinBlocks = DP > 64 ? 20 / kSplit : 8;
  static constexpr int kMinBlocksF = 8 / kSplit;
};

// dS of one element: row `qrow` of the (b, h) slice (`row_real`: < Tq),
// key `key`, logit s, dP dp; 0 for pad keys and replaced logits.
__device__ __forceinline__ float ds_of(float s, float dp, int qrow,
                                       bool row_real, int key,
                                       const float* bias, int64_t sb2,
                                       int64_t sb3, int Tk, int causal,
                                       float m, float l, float delta) {
  if (key >= Tk) return 0.f;
  if (bias != nullptr && row_real &&
      bias[(int64_t)qrow * sb2 + (int64_t)key * sb3] != 0.f)
    return 0.f;
  if (causal && key > qrow) return 0.f;
  return expf(s - m) / l * (dp - delta);
}

// m, l and Delta of the tile's rows into shared memory; pad rows get the
// safe m = 0, l = 1, Delta = 0
template <typename T>
__device__ __forceinline__ void load_stats(float* stats, const DqParams<T>& p,
                                           int64_t row_base, int qv, int tid,
                                           int nthreads) {
  for (int i = tid; i < 3 * kBQ; i += nthreads) {
    const int which = i / kBQ, r = i - which * kBQ;
    const float* src = which == 0 ? p.m : which == 1 ? p.l : p.delta;
    stats[i] = r < qv ? src[row_base + r] : (which == 1 ? 1.f : 0.f);
  }
}

// Both bodies lay shared memory out as Q, dO (kBQ x LD each) | the K/V
// ring (stages x (K, V unless k is v) x kBK x LD) | the f32 body's partial
// tiles | m, l, Delta (kBQ each).

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::kSplit * 32,
                                  DqShape<DP>::kMinBlocks)
flash_bwd_dq_tc_kernel(const DqParams<bf16> p) {
  using Shape = DqShape<DP>;
  constexpr int LD = Shape::kLd, DW = Shape::kDW, W = Shape::kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kBQ * LD;
  bf16* ring = g_s + kBQ * LD;
  const int per_stage = (p.kv_same ? 1 : 2) * kBK * LD;
  const int stages = p.nk > 1 ? 2 : 1;
  // W x {S, dP} x kBQ x kPld when the warps split D
  float* part = reinterpret_cast<float*>(ring + stages * per_stage);
  float* stats = part + (W > 1 ? W * 2 * kBQ * kPld : 0);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int dh = tid >> 5, lane = tid & 31;   // warp = column block of D
  const int g = lane >> 2, t = lane & 3;
  const int c0 = dh * DW;

  int cell = blockIdx.x;
  const int qt = cell % p.nq;
  cell /= p.nq;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int q0 = qt * kBQ;
  const int qv = min(kBQ, p.Tq - q0);

  const bf16* k = p.k + b * p.sk[0] + h * p.sk[1];
  const bf16* v = p.v + b * p.sv[0] + h * p.sv[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];

  stage_rows(q_s, LD, p.q + b * p.sq[0] + h * p.sq[1] + (int64_t)q0 * p.sq[2],
             p.sq[2], p.sq[3], qv, kBQ, p.D, DP, p.vq, tid, nthreads);
  stage_rows(g_s, LD, p.g + b * p.sg[0] + h * p.sg[1] + (int64_t)q0 * p.sg[2],
             p.sg[2], p.sg[3], qv, kBQ, p.D, DP, p.vg, tid, nthreads);
  load_stats(stats, p, ((int64_t)b * p.H + h) * p.Tq + q0, qv, tid,
             nthreads);

  auto load_kv = [&](int j) {
    const int k0 = j * kBK;
    const int kv = min(kBK, p.Tk - k0);
    bf16* ks = ring + (j % stages) * per_stage;
    stage_rows(ks, LD, k + (int64_t)k0 * p.sk[2], p.sk[2], p.sk[3], kv, kBK,
               p.D, DP, p.vk, tid, nthreads);
    if (!p.kv_same)
      stage_rows(ks + kBK * LD, LD, v + (int64_t)k0 * p.sv[2], p.sv[2],
                 p.sv[3], kv, kBK, p.D, DP, p.vv, tid, nthreads);
  };
  load_kv(0);
  cp_async_commit();

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dh * DW + (lane >> 4) * 8;

  for (int j = 0; j < p.nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j has landed; every warp is done with tile j-1
    if (j + 1 < p.nk) {
      load_kv(j + 1);  // into the stage tile j-1 used
      cp_async_commit();
    }
    const bf16* ks = ring + (j % stages) * per_stage;
    const bf16* vs = p.kv_same ? ks : ks + kBK * LD;
    const int k0 = j * kBK;

    // S = Q K^T and dP = dO V^T, 16 queries x 16 keys each: partial sums
    // over this warp's columns
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk) {
      const int c = c0 + 16 * kk;
      uint32_t a[4], bb[4];
      ldmatrix_x4(a, q_s + a_off + c);
      ldmatrix_x4(bb, ks + b_off + c);
      mma_bf16(s[0], a, bb[0], bb[1]);
      mma_bf16(s[1], a, bb[2], bb[3]);
      ldmatrix_x4(a, g_s + a_off + c);
      ldmatrix_x4(bb, vs + b_off + c);
      mma_bf16(dp[0], a, bb[0], bb[1]);
      mma_bf16(dp[1], a, bb[2], bb[3]);
    }
    if constexpr (W > 1) {
      // the partials meet in shared memory; every warp sums all of them in
      // the same order, so every warp forms the same dS
      float* ps = part + dh * 2 * kBQ * kPld;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (g + 8 * (e >> 1)) * kPld + 8 * n + 2 * t + (e & 1);
          ps[at] = s[n][e];
          ps[kBQ * kPld + at] = dp[n][e];
        }
      __syncthreads();   // every warp's partials are in
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (g + 8 * (e >> 1)) * kPld + 8 * n + 2 * t + (e & 1);
          float sv = 0.f, dpv = 0.f;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            sv += part[2 * w * kBQ * kPld + at];
            dpv += part[(2 * w + 1) * kBQ * kPld + at];
          }
          s[n][e] = sv;
          dp[n][e] = dpv;
        }
    }

    // dS in f32 on the fragment (rows g, g+8; keys 8n + 2t, +1)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = g + 8 * (e >> 1);
        s[n][e] = ds_of(s[n][e], dp[n][e], q0 + qi, qi < qv,
                        k0 + 8 * n + 2 * t + (e & 1), bias, p.sb[2], p.sb[3],
                        p.Tk, p.causal, stats[qi], stats[kBQ + qi],
                        stats[2 * kBQ + qi]);
      }

    // dQ += dS K on this warp's columns (dS rounded to bf16)
    const uint32_t ad[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int nd = 0; nd < DW / 16; ++nd) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, ks + bt_off + 16 * nd);
      mma_bf16(acc[2 * nd], ad, bb[0], bb[1]);
      mma_bf16(acc[2 * nd + 1], ad, bb[2], bb[3]);
    }
  }

  __syncthreads();   // every warp is done reading Q
  bf16* blk = q_s + c0;
  stage_frag(blk, LD, acc, g, t);
  __syncwarp();
  store_block(p.dq + b * p.sdq[0] + h * p.sdq[1] + (int64_t)q0 * p.sdq[2],
              p.sdq[2], p.sdq[3], blk, LD, qv, c0, DW, p.D, p.vdq, lane);
}

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::kSplit * 32,
                                  DqShape<DP>::kMinBlocksF)
flash_bwd_dq_3xtf32_kernel(const DqParams<float> p) {
  using Shape = DqShape<DP>;
  constexpr int LD = Shape::kLd, DW = Shape::kDW, W = Shape::kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* g_s = q_s + kBQ * LD;
  float* ring = g_s + kBQ * LD;
  const int per_stage = (p.kv_same ? 1 : 2) * kBK * LD;
  const int stages = p.nk > 1 ? 2 : 1;
  float* part = ring + stages * per_stage;   // W x {S, dP} x kBQ x kPld
  float* stats = part + W * 2 * kBQ * kPld;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int dh = tid >> 5, lane = tid & 31;   // warp = column block of D
  const int g = lane >> 2, t = lane & 3;
  const int c0 = dh * DW;

  int cell = blockIdx.x;
  const int qt = cell % p.nq;
  cell /= p.nq;
  const int h = cell % p.H;
  const int b = cell / p.H;
  const int q0 = qt * kBQ;
  const int qv = min(kBQ, p.Tq - q0);

  const float* k = p.k + b * p.sk[0] + h * p.sk[1];
  const float* v = p.v + b * p.sv[0] + h * p.sv[1];
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.sb[0] + h * p.sb[1];

  stage_rows(q_s, LD, p.q + b * p.sq[0] + h * p.sq[1] + (int64_t)q0 * p.sq[2],
             p.sq[2], p.sq[3], qv, kBQ, p.D, DP, p.vq, tid, nthreads);
  stage_rows(g_s, LD, p.g + b * p.sg[0] + h * p.sg[1] + (int64_t)q0 * p.sg[2],
             p.sg[2], p.sg[3], qv, kBQ, p.D, DP, p.vg, tid, nthreads);
  load_stats(stats, p, ((int64_t)b * p.H + h) * p.Tq + q0, qv, tid,
             nthreads);

  auto load_kv = [&](int j) {
    const int k0 = j * kBK;
    const int kv = min(kBK, p.Tk - k0);
    float* ks = ring + (j % stages) * per_stage;
    stage_rows(ks, LD, k + (int64_t)k0 * p.sk[2], p.sk[2], p.sk[3], kv, kBK,
               p.D, DP, p.vk, tid, nthreads);
    if (!p.kv_same)
      stage_rows(ks + kBK * LD, LD, v + (int64_t)k0 * p.sv[2], p.sv[2],
                 p.sv[3], kv, kBK, p.D, DP, p.vv, tid, nthreads);
  };
  load_kv(0);
  cp_async_commit();

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* ps = part + dh * 2 * kBQ * kPld;     // this warp's partial S
  float* pd = ps + kBQ * kPld;                // and dP

  for (int j = 0; j < p.nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j has landed; every warp is done with tile j-1
    if (j + 1 < p.nk) {
      load_kv(j + 1);  // into the stage tile j-1 used
      cp_async_commit();
    }
    const float* ks = ring + (j % stages) * per_stage;
    const float* vs = p.kv_same ? ks : ks + kBK * LD;
    const int k0 = j * kBK;

    // partial S = Q K^T and dP = dO V^T over this warp's columns; in each
    // k8 step the thread's k = t and k = t + 4 are columns 2t and 2t + 1
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < DW / 8; ++kk) {
      const int c = c0 + 8 * kk + 2 * t;
      uint32_t qb[4], qs[4], gb[4], gs[4];
      {
        const float2 lo = *reinterpret_cast<const float2*>(q_s + g * LD + c);
        const float2 hi =
            *reinterpret_cast<const float2*>(q_s + (g + 8) * LD + c);
        split_tf32(lo.x, qb[0], qs[0]);
        split_tf32(hi.x, qb[1], qs[1]);
        split_tf32(lo.y, qb[2], qs[2]);
        split_tf32(hi.y, qb[3], qs[3]);
      }
      {
        const float2 lo = *reinterpret_cast<const float2*>(g_s + g * LD + c);
        const float2 hi =
            *reinterpret_cast<const float2*>(g_s + (g + 8) * LD + c);
        split_tf32(lo.x, gb[0], gs[0]);
        split_tf32(hi.x, gb[1], gs[1]);
        split_tf32(lo.y, gb[2], gs[2]);
        split_tf32(hi.y, gb[3], gs[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t b0, b1, s0, s1;
        float ts[4] = {0.f, 0.f, 0.f, 0.f}, tp[4] = {0.f, 0.f, 0.f, 0.f};
        const float2 kx =
            *reinterpret_cast<const float2*>(ks + (8 * n + g) * LD + c);
        split_tf32(kx.x, b0, s0);
        split_tf32(kx.y, b1, s1);
        mma_3xtf32(ts, qb, qs, b0, b1, s0, s1);
        const float2 vx =
            *reinterpret_cast<const float2*>(vs + (8 * n + g) * LD + c);
        split_tf32(vx.x, b0, s0);
        split_tf32(vx.y, b1, s1);
        mma_3xtf32(tp, gb, gs, b0, b1, s0, s1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] += ts[e];
          dp[n][e] += tp[e];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (g + 8 * (e >> 1)) * kPld + 8 * n + 2 * t + (e & 1);
        ps[at] = s[n][e];
        pd[at] = dp[n][e];
      }
    __syncthreads();   // every warp's partials are in

    // dS in the tf32 A layout of the two 8-key blocks: rows g, g + 8 and
    // keys t, t + 4 of each block, summed over the warps' partials
    uint32_t db[2][4], dsm[2][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = g + 8 * (r & 1);
        const int col = 8 * kb + t + 4 * (r >> 1);
        float sv = 0.f, dpv = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          sv += part[(2 * w) * kBQ * kPld + qi * kPld + col];
          dpv += part[(2 * w + 1) * kBQ * kPld + qi * kPld + col];
        }
        const float dsv =
            ds_of(sv, dpv, q0 + qi, qi < qv, k0 + col, bias, p.sb[2],
                  p.sb[3], p.Tk, p.causal, stats[qi], stats[kBQ + qi],
                  stats[2 * kBQ + qi]);
        split_tf32(dsv, db[kb][r], dsm[kb][r]);
      }

    // dQ += dS K on this warp's columns
#pragma unroll
    for (int nd = 0; nd < DW / 8; ++nd) {
      float tq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const float* kc = ks + (8 * kb + t) * LD + c0 + 8 * nd + g;
        uint32_t b0, b1, s0, s1;
        split_tf32(kc[0], b0, s0);
        split_tf32(kc[4 * LD], b1, s1);
        mma_3xtf32(tq, db[kb], dsm[kb], b0, b1, s0, s1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += tq[e];
    }
  }

  __syncthreads();   // every warp is done reading Q
  float* blk = q_s + c0;
  stage_frag(blk, LD, acc, g, t);
  __syncwarp();
  store_block(p.dq + b * p.sdq[0] + h * p.sdq[1] + (int64_t)q0 * p.sdq[2],
              p.sdq[2], p.sdq[3], blk, LD, qv, c0, DW, p.D, p.vdq, lane);
}

template <int DP, typename T>
cudaError_t launch(const DqParams<T>& p, cudaStream_t stream) {
  using Shape = DqShape<DP>;
  constexpr bool f32 = sizeof(T) == 4;
  const int stages = p.nk > 1 ? 2 : 1;
  const size_t smem =
      sizeof(T) * Shape::kLd *
          (2 * (size_t)kBQ + (size_t)stages * (p.kv_same ? 1 : 2) * kBK) +
      sizeof(float) *
          ((f32 || Shape::kSplit > 1 ? (size_t)Shape::kSplit * 2 * kBQ * kPld
                                     : 0) +
           3 * kBQ);
  void (*kernel)(const DqParams<T>);
  if constexpr (f32)
    kernel = flash_bwd_dq_3xtf32_kernel<DP>;
  else
    kernel = flash_bwd_dq_tc_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)p.B * p.H * p.nq;
  kernel<<<(unsigned)grid, Shape::kSplit * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// Fill the parameters from t2o_flash_bwd_dq's arguments (validated there)
// and launch the body built for D padded to 16, 32, 64, 128 or 256.
template <typename T>
int run(const void* q, const void* k, const void* v, const float* bias,
        const void* g, const float* m, const float* l, const float* delta,
        void* dq, int B, int H, int Tq, int Tk, int D,
        const int64_t* strides, int causal, void* stream) {
  DqParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.g = static_cast<const T*>(g);
  p.bias = bias;
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dq = static_cast<T*>(dq);
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
    p.sdq[i] = strides[20 + i];
    same_strides = same_strides && p.sk[i] == p.sv[i];
  }
  p.causal = causal;
  p.kv_same = k == v && same_strides;
  auto rows_ok = [D](const void* ptr, const int64_t* s) {
    return sizeof(T) == 2 ? rows_of_8(ptr, s, D)
                          : D % 4 == 0 && rows_of_4(ptr, s, 0);
  };
  p.vq = rows_ok(q, p.sq);
  p.vk = rows_ok(k, p.sk);
  p.vv = rows_ok(v, p.sv);
  p.vg = rows_ok(g, p.sg);
  p.vdq = rows_ok(dq, p.sdq);
  p.nq = (Tq + kBQ - 1) / kBQ;
  p.nk = (Tk + kBK - 1) / kBK;
  if ((int64_t)B * H * p.nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(D)) {
    case 16: return (int)launch<16>(p, s);
    case 32: return (int)launch<32>(p, s);
    case 64: return (int)launch<64>(p, s);
    case 128: return (int)launch<128>(p, s);
    default: return (int)launch<256>(p, s);
  }
}

}  // namespace

extern "C" {

// K2 for bf16 q, k, v, dO, dq; arguments as t2o_flash_bwd_dq (flash_bwd.cu),
// which validates them and calls this for dtype 1.
int t2o_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                          const float* bias, const void* g, const float* m,
                          const float* l, const float* delta, void* dq, int B,
                          int H, int Tq, int Tk, int D, const int64_t* strides,
                          int causal, void* stream) {
  return run<bf16>(q, k, v, bias, g, m, l, delta, dq, B, H, Tq, Tk, D,
                   strides, causal, stream);
}

// K2 for f32 (3xTF32), as t2o_flash_bwd_dq_bf16, for dtype 0.
int t2o_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                         const float* bias, const void* g, const float* m,
                         const float* l, const float* delta, void* dq, int B,
                         int H, int Tq, int Tk, int D, const int64_t* strides,
                         int causal, void* stream) {
  return run<float>(q, k, v, bias, g, m, l, delta, dq, B, H, Tq, Tk, D,
                    strides, causal, stream);
}

}  // extern "C"
