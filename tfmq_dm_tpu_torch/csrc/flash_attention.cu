// Flash-attention kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see ops/flash_attention.py).
//
// Counterparts of the Pallas kernels in tfmq_dm_tpu/ops/flash_attention.py:
//   tfmq_flash_f32  pquant 0 (fp)    <- _fp_kernel
//                   pquant 1         <- _quant_kernel
//   tfmq_flash_int8 (int8)           <- _int8_kernel
//   tfmq_flash_fqk  (fqk)            <- _fqk_kernel
//
// Layout: (B*H, T, D) row-major, no tile padding in device memory; the
// ragged key and query edges are masked in the kernel, and a head dim
// that is not a multiple of 4 (f32) or 16 (int8) is zero-filled in
// shared memory only.
//
// Blocking of fp and int8 (scalar FMA / dp4a). A block holds 32 query
// rows (8 warps x 4 rows) and walks the keys in tiles of 32, one key per
// lane: a lane computes the 4 scores of its key against its warp's rows,
// the warp reduces row max and sum with shuffles, and for P @ V each lane
// owns the head-dim columns lane + 32 i of its warp's 4 rows (the
// accumulators stay in registers; D <= 384). The TPU kernels' large VMEM
// tiles (512 x 2048) become small tiles in shared memory: the f32 kernel
// needs 145 KB at D = 384 (dynamic shared memory), the int8 kernel 37 KB.
//
// Softmax-output quantization (pquant, and int8 with a p quantizer) needs
// the exact normalized probabilities, which the online rescaling cannot
// give. The Pallas kernels cache e = exp(s - m) in a (block_q, Tk) f32
// scratch; at Tk = 1024 that is 128 KB for 32 rows and 256 KB for 64,
// beyond what a block can hold here. These kernels recompute the scores in
// a second pass instead: pass 1 gives the row max m and the denominator l
// online, and the running max m_b at the end of each key block of bk
// columns (the Pallas call's block_k, 2048 by default); pass 2 recomputes
// s bit for bit (same code, same order), takes e = exp(s - m_b) against
// its block's max and quantizes round(e f) with the row factor
// f = exp(m_b - m) / (l delta): the Pallas kernels' own operand, block by
// block (flash_attention.py:134-163). The block maxes of a block's 32 rows
// live in shared memory (MAX_KB blocks at most). The plain versions in
// ops/flash_attention.py take exactly this rounding.
//
// int8: q/k/v arrive as centered int8 codes (quantized outside, with row
// sums), QK runs on dp4a with int32 sums, and the zero-point corrections
// dq dk (acc - zk' sum q - zq' sum k + D zq' zk') sm_scale are evaluated
// in the Pallas kernel's order without contraction (__fmul_rn/__fsub_rn),
// so recomputed scores are bit-identical to the first pass. With a p
// quantizer, P @ V runs on integer p levels and v codes with int32 sums,
// and the rank-1 corrections are folded over the real keys only, in
// 64-bit integers (exact), so padded keys contribute nothing.
//
// fqk (the bf16 fast deploy): q/k/v arrive in bf16. What bounds it on this
// card: at cin256 (B*H 4, T 1024, D 384) its three products (S in two
// passes, P @ V) are 9.7 GFLOP against 6.3 MB of q/k/v/o, so the bf16
// tensor-core rate bounds it (~0.01 ms); at SD's D 40 the expf of the two
// passes weighs as much as the products. Its first version ran the
// products as scalar FMA from f32 shared memory and fake-quantized every
// K/V tile in each block and in both passes. This one:
//   - a pre-pass kernel (fqk_prepass_kernel, one launch per call, grid
//     over key tiles, head-dim tiles and B*H) fake-quantizes K and V once
//     per head (_fq: f32 q/dq, then bf16) into bf16 scratch (B*H, Tk
//     padded to 64, D padded to DP), zero past Tk and D; for int8_pv it
//     writes the centered v codes transposed, (B*H, DP, Tk padded), so
//     that the s8 B fragments of m16n8k32 are rows of keys, and per-tile
//     column sums of the codes over the real keys. A block takes 64 keys
//     x 64 columns with 16-byte loads and stores (the codes are
//     transposed in shared memory), so the pass is spread over the card.
//     The TPU kernel does the same work once per (b, h) into VMEM
//     scratch (_fqk_kernel's _prep);
//   - the main kernel (flash_fqk_kernel<DP, MODE>) fake-quantizes its Q
//     tile once into bf16 shared memory, brings the K (and V or v-code)
//     tiles of the scratch into a two-stage cp.async ring, and runs
//     S = Q K^T on mma.sync m16n8k16 (bf16 -> f32, ldmatrix fragments).
//     A block holds RG groups of 16 query rows; the NC warps of a row
//     group split the key tile for S (each keeps its own running max and
//     denominator, combined after pass 1; a key block's max m_b is the
//     max over the warps, exact) and split the head dim for P @ V, so the
//     O accumulators stay at DP / NC columns a warp (96 at D 384). P is
//     bf16 p (mode 0) or the softmax quantizer's levels (mode 1, exact in
//     bf16) on m16n8k16, or (int8_pv) levels - 128 as int8 on m16n8k32
//     s8 with the exact int64 rank-1 corrections of the v zero point over
//     the real keys. P goes through shared memory between the two
//     products, except where one warp holds a row group and P is bf16:
//     there the S accumulators, laid out as A fragments, stay in
//     registers.
//   Pass 2 recomputes S with the same code on the same tiles, so it is bit
//   for bit pass 1's, and the block maxes m_b apply.
//
// pquant (flash_pq_kernel<DP>, f32 q/k/v): at cin256 (B*H 4, T 1024,
// D 384) one S and one P @ V are 6.4 GFLOP on 25 MB, so the tensor cores
// bound it (0.013 ms at the 495 TFLOP/s TF32 rate). Its first version ran
// both products as scalar f32 FMA. This one runs them on mma.sync
// m16n8k8 TF32 at f32 accuracy:
//   - S: each f32 operand is split as x = hi + lo, hi = tf32(x) (cvt.rna),
//     lo = tf32(x - hi), and S = hi.hi + (hi.lo + lo.hi) in f32
//     accumulators (lo.lo dropped): about 2^-21 relative to |q||k|, the
//     order of the f32 summation differences the one-level rule admits. A
//     single TF32 (or bf16) product would move s by ~1e-3 relative and
//     flip softmax levels in a large share of rows;
//   - P @ V: the levels (p_q - zp) are integers; below 2^11 in magnitude
//     (the 8-bit grid) they are exact in TF32 and run as one operand, else
//     (the 16-bit grid, up to 65535, or a fractional zp) they are split
//     the same way, level = hi + lo, exactly for integers below 2^22.
//     v is split hi + lo too, and P @ V = L.v_hi + L.v_lo (+ L_lo.v_hi):
//     every product is exact in f32 (11 x 11 bits), v is carried to about
//     2^-22, and the sums are f32;
//   - NC warps share a row group of 16 query rows and split its head dim
//     for both products (8 warps at D 384: 48 columns each): each warp
//     keeps its rows' Q fragments, split once, in registers, takes the
//     partial S of its columns for the whole key tile, and the group adds
//     the NC partials through shared memory in warp order (the same order
//     in both passes, so pass 2's S is pass 1's bit for bit and the block
//     maxes m_b apply). For the softmax each lane then owns one row and a
//     run of keys (rows reduce over 32 * NC / 16 lanes with shuffles), so
//     every row's max, denominator and block maxes are one warp's, with no
//     merge across warps; the denominator adds each tile's f32 sum to a
//     double. The levels go to shared memory, and each warp runs P @ V
//     on its own columns, so the O accumulators stay at DP / NC a warp;
//   - K comes through a two-stage cp.async ring of f32 tiles (32 keys),
//     V through one tile loaded while S is computed (zero-filled past Tk
//     and d); both are split into hi / lo as the fragments are read (3
//     instructions a value, no scratch). 203 KB of shared memory at D 384
//     with MAX_KB block maxes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

#include <type_traits>

namespace {

using tfmq::SmemAttr;
using tfmq::raise_smem;

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // keys per tile (one per lane)
constexpr int RPW = 4;        // query rows per warp
constexpr int NTHREADS = 256; // 8 warps
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_KB = 64;    // key blocks whose maxes a block keeps

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// rows [row0, row0 + 32) of a (rows, d) matrix into shared memory with row
// stride `stride`, zero-filled past the last row and past column d up to dp
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int stride, const T* src,
                                          int row0, int rows, int d,
                                          int dp) {
  for (int idx = threadIdx.x; idx < 32 * dp; idx += NTHREADS) {
    const int r = idx / dp, c = idx - r * dp;
    const int row = row0 + r;
    dst[r * stride + c] =
        (row < rows && c < d) ? src[(size_t)row * d + c] : T(0);
  }
}

// after key tile kt of pass 1: at the end of a key block (or of the keys),
// the rows' running maxes are that block's m_b
__device__ __forceinline__ void record_block_max(float* mblk,
                                                 const float (&m)[RPW],
                                                 int warp, int lane, int kt,
                                                 int nkt, int bk) {
  if (lane == 0 && (((kt + 1) * BK) % bk == 0 || kt == nkt - 1)) {
    const int kb = kt * BK / bk;
#pragma unroll
    for (int r = 0; r < RPW; ++r) mblk[(warp * RPW + r) * MAX_KB + kb] = m[r];
  }
}

// ---------------------------------------------------------------------------
// f32 operands, mode fp: online softmax, scalar FMA
// ---------------------------------------------------------------------------

template <int NC>
__device__ __forceinline__ void scores_f32(float (&s)[RPW], const float* qs,
                                           const float* ks, int dp, int ksd,
                                           int warp, int lane, int key,
                                           int tk, float sm_scale) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = 0.f;
  const float4* kr = reinterpret_cast<const float4*>(ks + lane * ksd);
  const float4* qr = reinterpret_cast<const float4*>(qs + warp * RPW * dp);
  const int n4 = dp >> 2;
  for (int c = 0; c < n4; ++c) {
    const float4 kv = kr[c];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float4 qv = qr[r * n4 + c];
      s[r] = fmaf(qv.x, kv.x, s[r]);
      s[r] = fmaf(qv.y, kv.y, s[r]);
      s[r] = fmaf(qv.z, kv.z, s[r]);
      s[r] = fmaf(qv.w, kv.w, s[r]);
    }
  }
  const bool valid = key < tk;
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = valid ? s[r] * sm_scale : NEG_INF;
}

// acc[r][i] += p[r] (of key j, broadcast from lane j) * V[j][lane + 32 i]
template <int NC>
__device__ __forceinline__ void pv_f32(float (&acc)[RPW][NC],
                                       const float (&p)[RPW],
                                       const float* vs, int dp, int d,
                                       int lane, int nkeys) {
  for (int j = 0; j < nkeys; ++j) {
    float pj[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) pj[r] = __shfl_sync(FULL, p[r], j);
    const float* vr = vs + j * dp;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        const float vv = vr[c];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
      }
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int tq,
                 int tk, int d, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) & ~3;
  const int ksd = dp + 4;  // float4 reads by 32 lanes hit 32 banks
  float* qs = smem;
  float* ks = qs + BQ * dp;
  float* vs = ks + BK * ksd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  load_tile(qs, dp, qb, q0, tq, d, dp);

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  const int nkt = (tk + BK - 1) / BK;

  // online row max, denominator and output
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_tile(ks, ksd, kb, kt * BK, tk, d, dp);
    load_tile(vs, dp, vb, kt * BK, tk, d, dp);
    __syncthreads();
    float s[RPW];
    scores_f32<NC>(s, qs, ks, dp, ksd, warp, lane, kt * BK + lane, tk,
                   sm_scale);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
    }
    pv_f32<NC>(acc, s, vs, dp, d, lane, min(BK, tk - kt * BK));
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= tq) continue;
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = acc[r][i] / l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// int8 operands (centered codes): int8 QK, online softmax or p quant
// ---------------------------------------------------------------------------

struct I8Scalars {
  float dqdk, zq_c, zk_c, dzz, dv, zv_c, dw, zw;
};

__device__ __forceinline__ I8Scalars i8_scalars(const float* sc, int d) {
  // sc = [dq, zq, dk, zk, dv, zv, dw, zw]
  I8Scalars r;
  r.dqdk = __fmul_rn(sc[0], sc[2]);
  r.zq_c = __fsub_rn(sc[1], 128.f);
  r.zk_c = __fsub_rn(sc[3], 128.f);
  r.dzz = __fmul_rn(__fmul_rn((float)d, r.zq_c), r.zk_c);
  r.dv = sc[4];
  r.zv_c = __fsub_rn(sc[5], 128.f);
  r.dw = sc[6];
  r.zw = sc[7];
  return r;
}

__device__ __forceinline__ void scores_i8(float (&s)[RPW], const int* qs,
                                          const int* ks, int dw, int ksd,
                                          int warp, int lane, int key,
                                          int tk, const float (&qsum)[RPW],
                                          float ksum, const I8Scalars& c,
                                          float sm_scale) {
  int a[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) a[r] = 0;
  const int4* kr = reinterpret_cast<const int4*>(ks + lane * ksd);
  const int4* qr = reinterpret_cast<const int4*>(qs + warp * RPW * dw);
  const int n4 = dw >> 2;
  for (int j = 0; j < n4; ++j) {
    const int4 kv = kr[j];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int4 qv = qr[r * n4 + j];
      a[r] = __dp4a(qv.x, kv.x, a[r]);
      a[r] = __dp4a(qv.y, kv.y, a[r]);
      a[r] = __dp4a(qv.z, kv.z, a[r]);
      a[r] = __dp4a(qv.w, kv.w, a[r]);
    }
  }
  const bool valid = key < tk;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float x = __fsub_rn((float)a[r], __fmul_rn(c.zk_c, qsum[r]));
    x = __fsub_rn(x, __fmul_rn(c.zq_c, ksum));
    x = __fadd_rn(x, c.dzz);
    const float sv = __fmul_rn(__fmul_rn(c.dqdk, x), sm_scale);
    s[r] = valid ? sv : NEG_INF;
  }
}

template <int NC, bool PQ>
__global__ void __launch_bounds__(NTHREADS)
flash_i8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                const int8_t* __restrict__ v8,
                const float* __restrict__ qsum_g,
                const float* __restrict__ ksum_g,
                const int* __restrict__ vsum_g, const float* __restrict__ sc,
                float* __restrict__ o, int tq, int tk, int d, int bk,
                float sm_scale, float wnb, float wpb) {
  extern __shared__ __align__(16) int smem_i[];
  const int dp = (d + 15) & ~15;
  const int dw = dp >> 2;     // int32 words per row
  const int ksd = dw + 4;
  int* qs = smem_i;
  int* ks = qs + BQ * dw;
  float* mblk = reinterpret_cast<float*>(ks + BK * ksd);  // [BQ][MAX_KB]
  int8_t* vs = reinterpret_cast<int8_t*>(mblk + BQ * MAX_KB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int8_t* qb = q8 + (size_t)bh * tq * d;
  const int8_t* kb = k8 + (size_t)bh * tk * d;
  const int8_t* vb = v8 + (size_t)bh * tk * d;
  const I8Scalars c = i8_scalars(sc, d);
  load_tile(reinterpret_cast<int8_t*>(qs), dp, qb, q0, tq, d, dp);

  float qsum[RPW], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    qsum[r] = row < tq ? qsum_g[(size_t)bh * tq + row] : 0.f;
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  const int nkt = (tk + BK - 1) / BK;
  float acc[RPW][NC];
  int pvi[RPW][PQ ? NC : 1];
  int psum[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    psum[r] = 0;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (PQ ? NC : 1); ++i) pvi[r][i] = 0;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int key = kt * BK + lane;
    __syncthreads();
    load_tile(reinterpret_cast<int8_t*>(ks), 4 * ksd, kb, kt * BK, tk, d,
              dp);
    if (!PQ) load_tile(vs, dp, vb, kt * BK, tk, d, dp);
    __syncthreads();
    const float ksum = key < tk ? ksum_g[(size_t)bh * tk + key] : 0.f;
    float s[RPW];
    scores_i8(s, qs, ks, dw, ksd, warp, lane, key, tk, qsum, ksum, c,
              sm_scale);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
      if (!PQ) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      }
    }
    if (PQ) record_block_max(mblk, m, warp, lane, kt, nkt, bk);
    if constexpr (!PQ) {
      // p stays f32; v dequantized in the kernel: dv (v' - zv')
      const int nkeys = min(BK, tk - kt * BK);
      for (int j = 0; j < nkeys; ++j) {
        float pj[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) pj[r] = __shfl_sync(FULL, s[r], j);
        const int8_t* vr = vs + j * dp;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int cc = lane + 32 * i;
          if (cc < d) {
            const float vd = __fmul_rn(c.dv, __fsub_rn((float)vr[cc],
                                                       c.zv_c));
#pragma unroll
            for (int r = 0; r < RPW; ++r)
              acc[r][i] = fmaf(pj[r], vd, acc[r][i]);
          }
        }
      }
    }
  }

  if constexpr (PQ) {
    float inv[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) inv[r] = 1.f / (l[r] * c.dw);
    for (int kt = 0; kt < nkt; ++kt) {
      const int key = kt * BK + lane;
      __syncthreads();
      load_tile(reinterpret_cast<int8_t*>(ks), 4 * ksd, kb, kt * BK, tk, d,
                dp);
      load_tile(vs, dp, vb, kt * BK, tk, d, dp);
      __syncthreads();
      const float ksum = key < tk ? ksum_g[(size_t)bh * tk + key] : 0.f;
      float s[RPW];
      scores_i8(s, qs, ks, dw, ksd, warp, lane, key, tk, qsum, ksum, c,
                sm_scale);
      int p8[RPW];
      const int kb = kt * BK / bk;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float mb = mblk[(warp * RPW + r) * MAX_KB + kb];
        const float e = expf(s[r] - mb);
        const float x =
            rintf(__fmul_rn(e, __fmul_rn(expf(mb - m[r]), inv[r])));
        const float pq = fminf(fmaxf(x + c.zw, wnb), wpb);
        p8[r] = key < tk ? (int)(pq - 128.f) : 0;
        psum[r] += warp_sum_int(p8[r]);
      }
      const int nkeys = min(BK, tk - kt * BK);
      for (int j = 0; j < nkeys; ++j) {
        int pj[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) pj[r] = __shfl_sync(FULL, p8[r], j);
        const int8_t* vr = vs + j * dp;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int vv = vr[min(lane + 32 * i, dp - 1)];
#pragma unroll
          for (int r = 0; r < RPW; ++r) pvi[r][i] += pj[r] * vv;
        }
      }
    }
  }

  const long long zvc = __float2ll_rn(c.zv_c);
  const long long wz = 128 - __float2ll_rn(c.zw);
  const float dwdv = __fmul_rn(c.dw, c.dv);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= tq) continue;
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int cc = lane + 32 * i;
      if (cc >= d) continue;
      if constexpr (PQ) {
        // sum over real keys of (p_q - zw)(v_q - zv), exact in 64 bits
        const long long corr =
            (long long)pvi[r][i] - zvc * (long long)psum[r] +
            wz * (long long)vsum_g[(size_t)bh * d + cc] - wz * zvc * tk;
        orow[cc] = __fmul_rn(dwdv, (float)corr);
      } else {
        orow[cc] = acc[r][i] / l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fqk: bf16 q/k/v fake-quantized on load, two passes
// ---------------------------------------------------------------------------

struct FqkRanges {
  float qnb, qpb, knb, kpb, vnb, vpb, wnb, wpb;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// _fq: bf16(delta (clip(round(x / delta) + zp, nb, pb) - zp)), f32 q/dq
__device__ __forceinline__ float fq_value(float x, float delta, float inv,
                                          float zp, float nb, float pb) {
  const float xq = fminf(fmaxf(__fadd_rn(rintf(__fmul_rn(x, inv)), zp), nb),
                         pb);
  return bf16r(__fmul_rn(delta, __fsub_rn(xq, zp)));
}

__device__ __forceinline__ float fq_code(float x, float inv, float zp,
                                         float nb, float pb) {
  return fminf(fmaxf(__fadd_rn(rintf(__fmul_rn(x, inv)), zp), nb), pb);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Keys are padded to FQK_KPAD in the scratch (a multiple of every key
// tile); a pre-pass block takes FQK_KPAD keys and FQK_PD head-dim columns.
constexpr int FQK_KPAD = 64;
constexpr int FQK_PD = 64;
constexpr int FQK_PRE_THREADS = 256;

// 8 consecutive values of row `key`, columns c0.. of a (rows, d) bf16
// matrix as f32, 0 past tk and d
__device__ __forceinline__ void load8(float* out, const __nv_bfloat16* m,
                                      int key, int c0, int tk, int d,
                                      bool vec) {
  if (key < tk && vec && c0 + 8 <= d) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(m + (size_t)key * d + c0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = (key < tk && c0 + i < d)
                   ? __bfloat162float(m[(size_t)key * d + c0 + i])
                   : 0.f;
  }
}

// 8 values fake-quantized (_fq), 0 past tk and d, stored as 8 bf16
__device__ __forceinline__ void store_fq8(__nv_bfloat16* dst, const float* x,
                                          int key, int c0, int tk, int d,
                                          float delta, float inv, float zp,
                                          float nb, float pb) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 2 * i + h;
      f[h] = (key < tk && c < d)
                 ? fq_value(x[2 * i + h], delta, inv, zp, nb, pb)
                 : 0.f;
    }
    __nv_bfloat162 v2 = __floats2bfloat162_rn(f[0], f[1]);
    w[i] = *reinterpret_cast<uint32_t*>(&v2);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One block: keys [t0, t0 + 64) x columns [c_base, c_base + 64) of one
// head. k -> kf (bf16, _fq); v -> vf (bf16, _fq), or for int8_pv v -> vt,
// the centered codes transposed (DP, Tkp) through shared memory, and
// vpart, this tile's column sums of the codes over the real keys. Zero
// past tk and d. 16-byte loads and stores where d allows.
__global__ void __launch_bounds__(FQK_PRE_THREADS)
fqk_prepass_kernel(const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ sc,
                   __nv_bfloat16* __restrict__ kf,
                   __nv_bfloat16* __restrict__ vf, int8_t* __restrict__ vt,
                   int* __restrict__ vpart, int tk, int tkp, int d, int dp,
                   int int8_pv, FqkRanges rg) {
  __shared__ __align__(16) int8_t codes[FQK_PD][FQK_KPAD + 16];
  const int bh = blockIdx.z, t0 = blockIdx.x * FQK_KPAD;
  const int c_base = blockIdx.y * FQK_PD;
  // sc = [dq, zq, dk, zk, dv, zv, dw, zw]
  const float dk = sc[2], zk = sc[3], dv = sc[4], zv = sc[5];
  const float ik = 1.f / dk, iv = 1.f / dv;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  const bool vec = d % 8 == 0 && ((uintptr_t)k % 16 == 0) &&
                   ((uintptr_t)v % 16 == 0);
  for (int i = threadIdx.x; i < FQK_KPAD * FQK_PD / 8;
       i += FQK_PRE_THREADS) {
    const int r = i / (FQK_PD / 8), cl = (i % (FQK_PD / 8)) * 8;
    const int c0 = c_base + cl, key = t0 + r;
    if (c0 >= dp) continue;
    const size_t o = ((size_t)bh * tkp + key) * dp + c0;
    float x[8];
    load8(x, kb, key, c0, tk, d, vec);
    store_fq8(kf + o, x, key, c0, tk, d, dk, ik, zk, rg.knb, rg.kpb);
    load8(x, vb, key, c0, tk, d, vec);
    if (!int8_pv) {
      store_fq8(vf + o, x, key, c0, tk, d, dv, iv, zv, rg.vnb, rg.vpb);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int code = 0;
        if (key < tk && c0 + e < d)
          code = (int)(fq_code(x[e], iv, zv, rg.vnb, rg.vpb) - 128.f);
        codes[cl + e][r] = (int8_t)code;
      }
    }
  }
  if (!int8_pv) return;
  __syncthreads();
  // thread: column cl = tid / 4, keys 16 q4 .. 16 q4 + 15
  const int cl = threadIdx.x >> 2, q4 = threadIdx.x & 3;
  const int c = c_base + cl;
  int sum = 0;
  if (c < dp) {
    const uint4 w = *reinterpret_cast<const uint4*>(&codes[cl][q4 * 16]);
    *reinterpret_cast<uint4*>(vt + ((size_t)bh * dp + c) * tkp + t0 +
                              q4 * 16) = w;
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      sum += (int)(int8_t)((ws[i >> 2] >> (8 * (i & 3))) & 0xffu);
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sum += __shfl_xor_sync(FULL, sum, 2);
  if (q4 == 0 && c < dp)
    vpart[((size_t)bh * gridDim.x + blockIdx.x) * dp + c] = sum;
}

// Per padded head dim: NC warps share a row group of 16 query rows (they
// split the key tile for S and the head dim for P @ V), RG row groups a
// block, key tiles of BK.
template <int DP> struct FqkCfg;
template <> struct FqkCfg<48> { static constexpr int NC = 1, RG = 4, BK = 64; };
template <> struct FqkCfg<80> { static constexpr int NC = 1, RG = 4, BK = 64; };
template <> struct FqkCfg<160> { static constexpr int NC = 2, RG = 2, BK = 64; };
template <> struct FqkCfg<384> { static constexpr int NC = 4, RG = 2, BK = 32; };

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int DP>
struct FqkShape {
  static constexpr int NC = FqkCfg<DP>::NC, RG = FqkCfg<DP>::RG,
                       BK = FqkCfg<DP>::BK;
  static constexpr int THREADS = 32 * NC * RG;
  static constexpr int BQ = 16 * RG;    // query rows a block
  static constexpr int KW = BK / NC;    // keys a warp scores per tile
  static constexpr int DC = DP / NC;    // head-dim columns a warp owns
  static constexpr int QP = DP + 8;     // bf16 pitch of Q, K, V tiles
  static constexpr int PP = BK + 8;     // bf16 pitch of the P tile
  static constexpr int BP = BK + 16;    // byte pitch of the int8 P / v tiles
  static constexpr int Q_BYTES = BQ * QP * 2;
  static constexpr int K_BYTES = BK * QP * 2;                    // a stage
  static constexpr int V_BYTES = cmax(BK * QP * 2, DP * BP);     // a stage
  static constexpr int P_BYTES = RG * 16 * PP * 2;
  // P stays in registers with one warp a row group and bf16 P (mode != 2)
  __host__ __device__ static constexpr bool preg(int mode) {
    return NC == 1 && mode != 2;
  }
  // bytes of shared memory for nkb key blocks (the block maxes last)
  static constexpr int smem(int mode, int nkb) {
    return Q_BYTES + 2 * K_BYTES + 2 * V_BYTES + (preg(mode) ? 0 : P_BYTES) +
           4 * (3 * NC * BQ + DP + NC * BQ * nkb);
  }
  static_assert(KW % 8 == 0 && DC % 16 == 0 && BK % 32 == 0, "tiles");
  static_assert(FQK_KPAD % BK == 0 && DP % 16 == 0, "padding");
  static_assert(2 * PP >= BP, "int8 P tile fits the bf16 one");
};

// MODE 0: p cast to bf16; 1: softmax-quantizer levels (p_q - zw);
// 2 (int8_pv): integer P @ V on p_q - 128 and v codes, exact corrections
template <int DP, int MODE>
__global__ void __launch_bounds__(FqkShape<DP>::THREADS)
flash_fqk_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kf,
                 const __nv_bfloat16* __restrict__ vf,
                 const int8_t* __restrict__ vt,
                 const int* __restrict__ vpart, const float* __restrict__ sc,
                 __nv_bfloat16* __restrict__ o, int tq, int tk, int tkp,
                 int d, int bk, int npre, float sm_scale, int zp_zero,
                 FqkRanges rg) {
  using S = FqkShape<DP>;
  constexpr int NC = S::NC, BQ = S::BQ, BK = S::BK, KW = S::KW, DC = S::DC;
  constexpr int QP = S::QP, PP = S::PP, BP = S::BP;
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u8);
  __nv_bfloat16* Ks =
      reinterpret_cast<__nv_bfloat16*>(smem_u8 + S::Q_BYTES);  // [2][BK][QP]
  unsigned char* Vst = smem_u8 + S::Q_BYTES + 2 * S::K_BYTES;   // 2 stages
  constexpr bool PREG = S::preg(MODE);
  unsigned char* Pt = Vst + 2 * S::V_BYTES;                     // [RG][16][.]
  float* mred = reinterpret_cast<float*>(Pt + (PREG ? 0 : S::P_BYTES));
  float* lred = mred + NC * BQ;                                 // [NC][BQ]
  int* pred = reinterpret_cast<int*>(lred + NC * BQ);           // [NC][BQ]
  int* vsum_s = pred + NC * BQ;                                 // [DP]
  float* mpart = reinterpret_cast<float*>(vsum_s + DP);         // [NC][BQ][nkb]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rgi = warp / NC, cw = warp % NC;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = rgi * 16;  // this warp's first row in the block
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float dw = sc[6], zw = sc[7];

  // the Q tile, fake-quantized once (zero past tq and d)
  {
    const float dq = sc[0], zq = sc[1], iq = 1.f / dq;
    const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
    for (int idx = tid; idx < BQ * DP; idx += S::THREADS) {
      const int r = idx / DP, c = idx - r * DP;
      const int row = q0 + r;
      Qs[r * QP + c] = __float2bfloat16_rn(
          (row < tq && c < d)
              ? fq_value(__bfloat162float(qb[(size_t)row * d + c]), dq, iq,
                         zq, rg.qnb, rg.qpb)
              : 0.f);
    }
  }

  const __nv_bfloat16* kbase = kf + (size_t)bh * tkp * DP;
  auto load_k = [&](int kt, int stage) {
    const __nv_bfloat16* src = kbase + (size_t)kt * BK * DP;
    __nv_bfloat16* dst = Ks + stage * BK * QP;
    for (int i = tid; i < BK * DP / 8; i += S::THREADS) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      cp_async16(dst + r * QP + c, src + r * DP + c);
    }
  };
  auto load_v = [&](int kt, int stage) {
    if constexpr (MODE == 2) {
      const int8_t* src = vt + (size_t)bh * DP * tkp + kt * BK;
      int8_t* dst = reinterpret_cast<int8_t*>(Vst + stage * S::V_BYTES);
      for (int i = tid; i < DP * BK / 16; i += S::THREADS) {
        const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
        cp_async16(dst + r * BP + c, src + (size_t)r * tkp + c);
      }
    } else {
      const __nv_bfloat16* src = vf + ((size_t)bh * tkp + kt * BK) * DP;
      __nv_bfloat16* dst =
          reinterpret_cast<__nv_bfloat16*>(Vst + stage * S::V_BYTES);
      for (int i = tid; i < BK * DP / 8; i += S::THREADS) {
        const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
        cp_async16(dst + r * QP + c, src + r * DP + c);
      }
    }
  };

  // S of this warp's 16 rows and its KW keys of tile kt (in `stage`):
  // s[j][e] is row g + 8 (e >> 1), key kt*BK + cw*KW + 8j + 2 t4 + (e & 1)
  // (a warp with one n8 tile sums even and odd k16 steps in two chains,
  // added at the end, so that two mma are in flight)
  constexpr int CH = KW / 8 == 1 ? 2 : 1;
  float s[KW / 8][4];
  auto scores = [&](int stage, int kt) {
    float sa[CH][KW / 8][4];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[c][j][e] = 0.f;
    const __nv_bfloat16* ks = Ks + stage * BK * QP + cw * KW * QP;
    static_assert(DP % (16 * CH) == 0, "chains");
#pragma unroll 2
    for (int k2 = 0; k2 < DP; k2 += 16 * CH)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int kk = k2 + 16 * c;
      float (&acc)[KW / 8][4] = sa[c];
      uint32_t a[4];
      ldsm_x4(a, Qs + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * QP + kk +
                     (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j + 1 < KW / 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * QP + kk +
                       ((lane >> 3) & 1) * 8);
        mma_bf16_16816(acc[j], a, b);
        mma_bf16_16816(acc[j + 1], a, b + 2);
      }
      if constexpr ((KW / 8) % 2 == 1) {
        uint32_t b[2];
        ldsm_x2(b, ks + ((KW / 8 - 1) * 8 + (lane & 7)) * QP + kk +
                       ((lane >> 3) & 1) * 8);
        mma_bf16_16816(acc[KW / 8 - 1], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + cw * KW + j * 8 + 2 * t4 + (e & 1);
        const float v = CH == 2 ? sa[0][j][e] + sa[CH - 1][j][e]
                                : sa[0][j][e];
        s[j][e] = key < tk ? v * sm_scale : NEG_INF;
      }
  };
  auto key_ok = [&](int kt, int j, int e) {
    return (kt + 1) * BK <= tk ||
           kt * BK + cw * KW + j * 8 + 2 * t4 + (e & 1) < tk;
  };

  const int nkt = (tk + BK - 1) / BK;
  const int nkb = ((nkt - 1) * BK) / bk + 1;

  // pass 1: each warp's running max and denominator over its keys, and its
  // running max at the end of each key block
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  load_k(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_k(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores(kt & 1, kt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key_ok(kt, j, e)) sum += expf(s[j][2 * h + e] - m_new);
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l_r[h] = l_r[h] * expf(m_r[h] - m_new) + sum;
      m_r[h] = m_new;
    }
    if (t4 == 0 && (((kt + 1) * BK) % bk == 0 || kt == nkt - 1)) {
      const int kb = kt * BK / bk;
      mpart[(cw * BQ + row0 + g) * nkb + kb] = m_r[0];
      mpart[(cw * BQ + row0 + g + 8) * nkb + kb] = m_r[1];
    }
    __syncthreads();
  }
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mred[cw * BQ + row0 + g + 8 * h] = m_r[h];
      lred[cw * BQ + row0 + g + 8 * h] = l_r[h];
    }
  }
  __syncthreads();
  // the row's max, its denominator (warps in order) and the block maxes
  float m_f[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    float m = mred[r];
#pragma unroll
    for (int c = 1; c < NC; ++c) m = fmaxf(m, mred[c * BQ + r]);
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      l += lred[c * BQ + r] * expf(mred[c * BQ + r] - m);
    m_f[h] = m;
    inv[h] = MODE == 0 ? 1.f / l : 1.f / (l * dw);
  }
  for (int i = tid; i < BQ * nkb; i += S::THREADS) {
    const int r = i / nkb, kb = i - r * nkb;
    float mb = mpart[r * nkb + kb];
#pragma unroll
    for (int c = 1; c < NC; ++c)
      mb = fmaxf(mb, mpart[(c * BQ + r) * nkb + kb]);
    mpart[r * nkb + kb] = mb;
  }

  // pass 2: recompute S, p against its block's max, P through shared
  // memory, P @ V on this warp's head-dim columns
  using Acc = typename std::conditional<MODE == 2, int, float>::type;
  Acc acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  int psum[2] = {0, 0};
  // one warp a row group (NC 1) and bf16 P: the S accumulators of two
  // neighbouring n8 tiles are an m16n8k16 A fragment, so P stays in
  // registers (pk[j][h]: row g + 8h, keys 8j + 2t4, +1)
  uint32_t pk[KW / 8][2];
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(Pt) + rgi * 16 * PP;
  int8_t* P8 = reinterpret_cast<int8_t*>(Pt) + rgi * 16 * BP;

  load_k(0, 0);
  load_v(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nkt) {
      load_k(kt + 1, st ^ 1);
      load_v(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores(st, kt);
    const int kb = kt * BK / bk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mb = mpart[(row0 + g + 8 * h) * nkb + kb];
      const float f = __fmul_rn(expf(mb - m_f[h]), inv[h]);
      const int r = g + 8 * h;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        float pv[2];
        int p8[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = key_ok(kt, j, e);
          const float x = __fmul_rn(expf(s[j][2 * h + e] - mb), f);
          pv[e] = 0.f;
          p8[e] = 0;
          if (MODE == 0) {
            pv[e] = valid ? x : 0.f;
          } else {
            const float xr = rintf(x);
            const float pq =
                zp_zero ? fminf(xr, rg.wpb)
                        : fminf(fmaxf(__fadd_rn(xr, zw), rg.wnb), rg.wpb);
            if (MODE == 1)
              pv[e] = valid ? (zp_zero ? pq : __fsub_rn(pq, zw)) : 0.f;
            else
              p8[e] = valid ? (int)(pq - 128.f) : 0;
          }
        }
        const int col = cw * KW + j * 8 + 2 * t4;
        if constexpr (MODE == 2) {
          psum[h] += p8[0] + p8[1];
          *reinterpret_cast<uint16_t*>(P8 + r * BP + col) =
              (uint16_t)((uint8_t)(int8_t)p8[0] |
                         ((uint16_t)(uint8_t)(int8_t)p8[1] << 8));
        } else {
          __nv_bfloat162 v2 = __floats2bfloat162_rn(pv[0], pv[1]);
          if constexpr (PREG)
            pk[j][h] = *reinterpret_cast<uint32_t*>(&v2);
          else
            *reinterpret_cast<__nv_bfloat162*>(Pb + r * PP + col) = v2;
        }
      }
    }
    if constexpr (!PREG) __syncthreads();
    if constexpr (MODE == 2) {
      const int8_t* vs = reinterpret_cast<const int8_t*>(Vst + st * S::V_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[4];
        ldsm_x4(a, P8 + ((lane & 7) + ((lane >> 3) & 1) * 8) * BP + kk +
                       (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < DC / 8; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, vs +
                         (cw * DC + j * 8 + (lane & 7) + (lane >> 4) * 8) * BP +
                         kk + ((lane >> 3) & 1) * 16);
          mma_s8_16832(acc[j], a, b);
          mma_s8_16832(acc[j + 1], a, b + 2);
        }
      }
    } else {
      const __nv_bfloat16* vs =
          reinterpret_cast<const __nv_bfloat16*>(Vst + st * S::V_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4];
        if constexpr (PREG) {
          a[0] = pk[kk / 8][0];
          a[1] = pk[kk / 8][1];
          a[2] = pk[kk / 8 + 1][0];
          a[3] = pk[kk / 8 + 1][1];
        } else {
          ldsm_x4(a, Pb + ((lane & 7) + ((lane >> 3) & 1) * 8) * PP + kk +
                         (lane >> 4) * 8);
        }
#pragma unroll
        for (int j = 0; j < DC / 8; j += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, vs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * QP +
                               cw * DC + j * 8 + (lane >> 4) * 8);
          mma_bf16_16816(acc[j], a, b);
          mma_bf16_16816(acc[j + 1], a, b + 2);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (MODE == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(FULL, psum[h], 1);
      psum[h] += __shfl_xor_sync(FULL, psum[h], 2);
      if (t4 == 0) pred[cw * BQ + row0 + g + 8 * h] = psum[h];
    }
    for (int c = tid; c < DP; c += S::THREADS) {
      int sum = 0;
      for (int t = 0; t < npre; ++t)
        sum += vpart[((size_t)bh * npre + t) * DP + c];
      vsum_s[c] = sum;
    }
    __syncthreads();
  }

  const long long zvc = __float2ll_rn(sc[5] - 128.f);
  const long long wz = 128 - __float2ll_rn(zw);
  const float dwdv = __fmul_rn(dw, sc[4]);
  const bool pair = (d & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    const int row = q0 + r;
    if (row >= tq) continue;
    long long ps = 0;
    if constexpr (MODE == 2) {
#pragma unroll
      for (int c = 0; c < NC; ++c) ps += pred[c * BQ + r];
    }
    __nv_bfloat16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int col = cw * DC + j * 8 + 2 * t4;
      float val[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (MODE == 2) {
          // sum over real keys of (p_q - zw)(v_q - zv), exact in 64 bits
          const long long vs = col + e < DP ? vsum_s[col + e] : 0;
          const long long corr = (long long)acc[j][2 * h + e] - zvc * ps +
                                 wz * vs - wz * zvc * tk;
          val[e] = __fmul_rn(dwdv, (float)corr);
        } else if constexpr (MODE == 1) {
          val[e] = __fmul_rn(dw, acc[j][2 * h + e]);
        } else {
          val[e] = acc[j][2 * h + e];
        }
      }
      if (pair && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(val[0], val[1]);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(val[0]);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(val[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pquant: f32 q/k/v, S on 3xTF32 mma.sync, P @ V on TF32 levels
// ---------------------------------------------------------------------------

// 16 / 4 bytes global -> shared, the rest zero-filled past `bytes`
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + r: hi = tf32(x), lo = tf32(x - hi), |r| <= 2^-22 |x|;
// exact (r = 0) for an integer below 2^22 in magnitude
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Per padded head dim (d rounded up to 40, 80, 160 or 384): NC warps
// share a row group of 16 query rows and split its head dim, RG row groups
// a block, key tiles of BK = 32 (one key a lane in the softmax step).
template <int DP> struct PqCfg;
template <> struct PqCfg<40> { static constexpr int NC = 1, RG = 8; };
template <> struct PqCfg<80> { static constexpr int NC = 2, RG = 4; };
template <> struct PqCfg<160> { static constexpr int NC = 4, RG = 2; };
template <> struct PqCfg<384> { static constexpr int NC = 8, RG = 2; };

// a row pitch (words) whose 8 rows x 4 columns of B fragments read V
// ([key t4][column g]) hit 32 banks: 8 or 24 mod 32
constexpr int pq_vpitch(int dp) {
  return (dp % 32 == 8 || dp % 32 == 24) ? dp : pq_vpitch(dp + 8);
}

constexpr int SMEM_LIMIT = 232448;   // a block's shared memory, sm_90

template <int DP>
struct PqShape {
  static constexpr int NC = PqCfg<DP>::NC, RG = PqCfg<DP>::RG, BK = 32;
  static constexpr int THREADS = 32 * NC * RG;
  static constexpr int BQ = 16 * RG;   // query rows a block
  static constexpr int RW = 16 / NC;   // rows a warp takes the softmax of
  static constexpr int LPR = 32 / RW;  // lanes a row: E keys each
  static constexpr int E = BK / LPR;
  static constexpr int DC = DP / NC;   // head-dim columns a warp owns
  // word pitches: K rows ([key g][column t4]: 4 mod 8), V rows, the S
  // partials (float2 writes), the P planes (fragments [row g][key t4])
  static constexpr int KP = DP + 4, VP = pq_vpitch(DP);
  static constexpr int SP = BK + 8, PP = BK + 4;
  static constexpr int K_WORDS = BK * KP, V_WORDS = BK * VP;
  // a row group's S partials [NC][16][SP] and P planes [2][16][PP]
  static constexpr int G_WORDS = NC * 16 * SP + 2 * 16 * PP;
  // two K stages, one V tile, the row groups' words, the block maxes
  static constexpr int smem(int nkb) {
    return 4 * (2 * K_WORDS + V_WORDS + RG * G_WORDS + BQ * nkb);
  }
  static_assert(DC % 8 == 0 && DP % 8 == 0 && 16 % NC == 0 && E % 2 == 0,
                "tiles");
  static_assert(smem(MAX_KB) <= SMEM_LIMIT, "shared memory");
};

// The row group's warps meet (named barrier 1 + rgi), or the warp alone.
template <int NC>
__device__ __forceinline__ void rg_sync(int rgi) {
  if constexpr (NC > 1)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rgi), "r"(32 * NC)
                 : "memory");
  else
    __syncwarp();
}

// Softmax output quantized per key block (pquant). q, k, v (B*H, T, d)
// f32; dz = [delta, zp]; o = delta * sum_keys levels * v.
template <int DP>
__global__ void __launch_bounds__(PqShape<DP>::THREADS, 1)
flash_pq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dz,
                float* __restrict__ o, int tq, int tk, int d, int bk,
                float sm_scale, float nb, float pb, int zp_zero, int vec) {
  using S = PqShape<DP>;
  constexpr int NC = S::NC, BK = S::BK, RW = S::RW, DC = S::DC;
  constexpr int LPR = S::LPR, E = S::E;
  constexpr int KP = S::KP, VP = S::VP, SP = S::SP, PP = S::PP;
  extern __shared__ __align__(16) float smem_pq[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rgi = warp / NC, cw = warp % NC;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = rgi * 16;
  // the softmax step: lane -> row rl of the group, keys kl .. kl + E - 1
  const int rl = cw * RW + lane / LPR, kl = (lane % LPR) * E;
  float* kring = smem_pq;                              // [2][BK][KP]
  float* vbuf = kring + 2 * S::K_WORDS;                // [BK][VP]
  // this group's S partials [NC][16][SP], then its P planes
  float* grp = vbuf + S::V_WORDS + rgi * S::G_WORDS;
  float* ph = grp + NC * 16 * SP;                      // levels, hi [16][PP]
  float* pl = ph + 16 * PP;                            // lo [16][PP]
  float* mblk = vbuf + S::V_WORDS + S::RG * S::G_WORDS;  // [BQ][nkb]

  const int bh = blockIdx.y, q0 = blockIdx.x * S::BQ;
  const float* qb = q + (size_t)bh * tq * d;
  const float* kbase = k + (size_t)bh * tk * d;
  const float* vbase = v + (size_t)bh * tk * d;
  const float delta = dz[0], zp = dz[1];
  const int nkt = (tk + BK - 1) / BK;
  const int nkb = ((nkt - 1) * BK) / bk + 1;

  // this warp's Q fragments (rows g, g + 8 of its group; its DC columns),
  // split once: a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, ..)
  uint32_t qh[DC / 8][4], ql[DC / 8][4];
#pragma unroll
  for (int s8 = 0; s8 < DC / 8; ++s8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + row0 + g + 8 * (e & 1);
      const int c = cw * DC + 8 * s8 + t4 + 4 * (e >> 1);
      split_tf32((r < tq && c < d) ? qb[(size_t)r * d + c] : 0.f, qh[s8][e],
                 ql[s8][e]);
    }

  // BK rows of a (tk, d) operand from key tile kt, zero past tk and d
  auto load_rows = [&](float* dst, int pitch, const float* src, int kt) {
    for (int i = tid; i < BK * (DP / 4); i += S::THREADS) {
      const int r = i / (DP / 4), c = (i - r * (DP / 4)) * 4;
      const int key = kt * BK + r;
      float* to = dst + r * pitch + c;
      if (vec) {
        const bool in = key < tk && c < d;
        cp_async16z(to, in ? src + (size_t)key * d + c : src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = key < tk && c + e < d;
          cp_async4z(to + e, in ? src + (size_t)key * d + c + e : src,
                     in ? 4 : 0);
        }
      }
    }
  };

  // S of row rl and keys kt BK + kl + i (i < E) in s[i], scaled, NEG_INF
  // past tk. Each warp takes q k over its DC columns for
  // all BK keys on the tensor cores (hi hi in one chain of f32
  // accumulators, the cross terms hi lo + lo hi in another, added after),
  // writes the partial, and adds the group's NC partials of its rows in
  // warp order: the same order in both passes.
  float s[E];
  auto scores = [&](const float* ks, int kt) {
    float shh[BK / 8][4], sx[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) shh[j][e] = sx[j][e] = 0.f;
    const float* kw = ks + cw * DC + t4;
#pragma unroll
    for (int s8 = 0; s8 < DC / 8; ++s8)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float* kr = kw + (8 * j + g) * KP + 8 * s8;
        uint32_t bh_[2], bl_[2];
        split_tf32(kr[0], bh_[0], bl_[0]);
        split_tf32(kr[4], bh_[1], bl_[1]);
        mma_tf32_1688(shh[j], qh[s8], bh_);
        mma_tf32_1688(sx[j], qh[s8], bl_);
        mma_tf32_1688(sx[j], ql[s8], bh_);
      }
    float* mine = grp + cw * 16 * SP;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(mine + (g + 8 * h) * SP + 8 * j + 2 * t4) =
            make_float2(shh[j][2 * h] + sx[j][2 * h],
                        shh[j][2 * h + 1] + sx[j][2 * h + 1]);
    rg_sync<NC>(rgi);
    const float* pr = grp + rl * SP + kl;
#pragma unroll
    for (int i = 0; i < E; i += 2) {
      float2 a = *reinterpret_cast<const float2*>(pr + i);
#pragma unroll
      for (int c = 1; c < NC; ++c) {
        const float2 b =
            *reinterpret_cast<const float2*>(pr + c * 16 * SP + i);
        a.x += b.x;
        a.y += b.y;
      }
      s[i] = kt * BK + kl + i < tk ? a.x * sm_scale : NEG_INF;
      s[i + 1] = kt * BK + kl + i + 1 < tk ? a.y * sm_scale : NEG_INF;
    }
  };

  // pass 1: the rows' running max and denominator over the keys (the LPR
  // lanes of a row reduce with shuffles; the denominator adds each tile's
  // f32 sum to a double, so that hundreds of tiles (Tk 4096) round less
  // than the plain version's f32 sum: at the 16-bit grid a row's levels
  // move with 1/l), and the running max at the end of each key block
  float m_r = NEG_INF;
  double l_r = 0.0;
  load_rows(kring, KP, kbase, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_rows(kring + ((kt + 1) & 1) * S::K_WORDS, KP, kbase, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores(kring + (kt & 1) * S::K_WORDS, kt);
    float mx = s[0];
#pragma unroll
    for (int i = 1; i < E; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
    for (int o = LPR / 2; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_new = fmaxf(m_r, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (kt * BK + kl + i < tk) sum += expf(s[i] - m_new);
#pragma unroll
    for (int o = LPR / 2; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    l_r = l_r * (double)expf(m_r - m_new) + (double)sum;
    m_r = m_new;
    if ((((kt + 1) * BK) % bk == 0 || kt == nkt - 1) && lane % LPR == 0)
      mblk[(row0 + rl) * nkb + kt * BK / bk] = m_new;
    __syncthreads();
  }
  // the row's 1 / (l delta)
  const float inv = 1.f / ((float)l_r * delta);
  // the levels need a lo part where they are not integers below 2^11
  const bool psplit =
      zp_zero ? pb > 2048.f
              : (rintf(zp) != zp ||
                 fmaxf(fabsf(nb - zp), fabsf(pb - zp)) > 2048.f);

  // pass 2: recompute S, the levels against their block's max, P through
  // shared memory, P @ V on this warp's DC columns. K is double-buffered;
  // the V tile is loaded while S is computed.
  float oacc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  load_rows(kring, KP, kbase, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // K(kt) landed; tile kt - 1's V and P are consumed
    load_rows(vbuf, VP, vbase, kt);
    cp_async_commit();
    const bool more = kt + 1 < nkt;
    if (more) {
      load_rows(kring + ((kt + 1) & 1) * S::K_WORDS, KP, kbase, kt + 1);
      cp_async_commit();
    }
    scores(kring + (kt & 1) * S::K_WORDS, kt);
    const float mb = mblk[(row0 + rl) * nkb + kt * BK / bk];
    const float f = __fmul_rn(expf(mb - m_r), inv);
#pragma unroll
    for (int i = 0; i < E; i += 2) {
      uint32_t lh[2], ll[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = rintf(__fmul_rn(expf(s[i + e] - mb), f));
        const float lv = zp_zero ? fminf(x, pb)
                                 : fminf(fmaxf(x + zp, nb), pb) - zp;
        split_tf32(kt * BK + kl + i + e < tk ? lv : 0.f, lh[e], ll[e]);
      }
      const int off = rl * PP + kl + i;
      *reinterpret_cast<float2*>(ph + off) =
          make_float2(__uint_as_float(lh[0]), __uint_as_float(lh[1]));
      if (psplit)
        *reinterpret_cast<float2*>(pl + off) =
            make_float2(__uint_as_float(ll[0]), __uint_as_float(ll[1]));
    }
    if (more)
      cp_async_wait<1>();   // V(kt); K(kt + 1) may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();        // V(kt) and the group's P are visible
    const float* vs = vbuf + cw * DC + g;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (g + 8 * (e & 1)) * PP + 8 * k8 + t4 + 4 * (e >> 1);
        ah[e] = __float_as_uint(ph[off]);
        al[e] = psplit ? __float_as_uint(pl[off]) : 0u;
      }
#pragma unroll
      for (int n8 = 0; n8 < DC / 8; ++n8) {
        const float* vr = vs + (8 * k8 + t4) * VP + 8 * n8;
        uint32_t vh[2], vl[2];
        split_tf32(vr[0], vh[0], vl[0]);
        split_tf32(vr[4 * VP], vh[1], vl[1]);
        mma_tf32_1688(oacc[n8], ah, vh);
        mma_tf32_1688(oacc[n8], ah, vl);
        if (psplit) mma_tf32_1688(oacc[n8], al, vh);
      }
    }
  }

  const bool pair = (d & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + g + 8 * h;
    if (row >= tq) continue;
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int n8 = 0; n8 < DC / 8; ++n8) {
      const int col = cw * DC + 8 * n8 + 2 * t4;
      const float v0 = __fmul_rn(delta, oacc[n8][2 * h]);
      const float v1 = __fmul_rn(delta, oacc[n8][2 * h + 1]);
      if (pair && col + 1 < d) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < d) orow[col] = v0;
        if (col + 1 < d) orow[col + 1] = v1;
      }
    }
  }
}

bool key_blocks_ok(int tk, int bk) {
  return bk > 0 && bk % BK == 0 && (tk + bk - 1) / bk <= MAX_KB;
}

size_t f32_smem(int d) {
  const int dp = (d + 3) & ~3;
  return sizeof(float) * (BQ * dp + BK * (dp + 4) + BK * dp);
}

size_t i8_smem(int d) {
  const int dp = (d + 15) & ~15;
  return sizeof(int) * (BQ * (dp / 4) + BK * (dp / 4 + 4) + BQ * MAX_KB) +
         BK * dp;
}

// the padded head dim the fqk kernels take for d, or 0
int fqk_dp(int d) {
  return d <= 0 ? 0 : d <= 48 ? 48 : d <= 80 ? 80 : d <= 160 ? 160
                                                    : d <= 384 ? 384 : 0;
}

// the padded head dim the pquant kernel takes for d, or 0
int pq_dp(int d) {
  return d <= 0 ? 0 : d <= 40 ? 40 : d <= 80 ? 80 : d <= 160 ? 160
                                                    : d <= 384 ? 384 : 0;
}


template <int DP, int MODE>
int launch_fqk(const __nv_bfloat16* q, const __nv_bfloat16* kf,
               const __nv_bfloat16* vf, const int8_t* vt, const int* vpart,
               const float* sc, __nv_bfloat16* o, int bh, int tq, int tk,
               int tkp, int d, int bk, int npre, float sm_scale, int zp_zero,
               FqkRanges rg, cudaStream_t stream) {
  using S = FqkShape<DP>;
  static SmemAttr attr;
  const int e = raise_smem(flash_fqk_kernel<DP, MODE>, attr,
                           S::smem(MODE, MAX_KB));
  if (e) return e;
  if (bk % S::BK) return (int)cudaErrorInvalidValue;
  const int nkt = (tk + S::BK - 1) / S::BK;
  const int nkb = ((nkt - 1) * S::BK) / bk + 1;
  dim3 grid((tq + S::BQ - 1) / S::BQ, bh);
  flash_fqk_kernel<DP, MODE><<<grid, S::THREADS, S::smem(MODE, nkb),
                               stream>>>(
      q, kf, vf, vt, vpart, sc, o, tq, tk, tkp, d, bk, npre, sm_scale,
      zp_zero, rg);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int bh, int tq, int tk, int d, float sm_scale,
               cudaStream_t stream) {
  static SmemAttr attr;
  const int e = raise_smem(flash_f32_kernel<NC>, attr,
                           (int)f32_smem(32 * NC));
  if (e) return e;
  dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_f32_kernel<NC><<<grid, NTHREADS, f32_smem(d), stream>>>(
      q, k, v, o, tq, tk, d, sm_scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_pq(const float* q, const float* k, const float* v,
              const float* dz, float* o, int bh, int tq, int tk, int d,
              int bk, float sm_scale, float nb, float pb, int zp_zero,
              cudaStream_t stream) {
  using S = PqShape<DP>;
  static SmemAttr attr;
  const int e = raise_smem(flash_pq_kernel<DP>, attr, S::smem(MAX_KB));
  if (e) return e;
  if (bk % S::BK) return (int)cudaErrorInvalidValue;
  const int nkt = (tk + S::BK - 1) / S::BK;
  const int nkb = ((nkt - 1) * S::BK) / bk + 1;
  const int vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((tq + S::BQ - 1) / S::BQ, bh);
  flash_pq_kernel<DP><<<grid, S::THREADS, S::smem(nkb), stream>>>(
      q, k, v, dz, o, tq, tk, d, bk, sm_scale, nb, pb, zp_zero, vec);
  return (int)cudaGetLastError();
}

template <int NC, bool PQ>
int launch_i8(const int8_t* q8, const int8_t* k8, const int8_t* v8,
              const float* qsum, const float* ksum, const int* vsum,
              const float* sc, float* o, int bh, int tq, int tk, int d,
              int bk, float sm_scale, float wnb, float wpb,
              cudaStream_t stream) {
  static SmemAttr attr;
  const int e = raise_smem(flash_i8_kernel<NC, PQ>, attr,
                           (int)i8_smem(32 * NC));
  if (e) return e;
  dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_i8_kernel<NC, PQ><<<grid, NTHREADS, i8_smem(d), stream>>>(
      q8, k8, v8, qsum, ksum, vsum, sc, o, tq, tk, d, bk, sm_scale, wnb,
      wpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on the given stream (PyTorch's current stream) and
// returns cudaGetLastError() so that a refused launch is reported. Head
// dims above 384 are refused (cudaErrorInvalidValue); the wrapper checks
// first.

int tfmq_flash_f32(const void* q, const void* k, const void* v,
                   const void* dz, void* o, int bh, int tq, int tk, int d,
                   int bk, float sm_scale, int pquant, float nb, float pb,
                   int zp_zero, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!key_blocks_ok(tk, bk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *dzf = (const float*)dz;
  float* of = (float*)o;
  if (pquant) {
#define TFMQ_PQ(DP)                                                         \
  return launch_pq<DP>(qf, kf, vf, dzf, of, bh, tq, tk, d, bk, sm_scale, nb, \
                       pb, zp_zero, s)
    switch (pq_dp(d)) {
      case 40: TFMQ_PQ(40);
      case 80: TFMQ_PQ(80);
      case 160: TFMQ_PQ(160);
      case 384: TFMQ_PQ(384);
      default: return (int)cudaErrorInvalidValue;
    }
#undef TFMQ_PQ
  }
#define TFMQ_F32(NC) \
  return launch_f32<NC>(qf, kf, vf, of, bh, tq, tk, d, sm_scale, s)
  if (d <= 64) TFMQ_F32(2);
  if (d <= 160) TFMQ_F32(5);
  if (d <= 384) TFMQ_F32(12);
#undef TFMQ_F32
  return (int)cudaErrorInvalidValue;
}

int tfmq_flash_int8(const void* q8, const void* k8, const void* v8,
                    const void* qsum, const void* ksum, const void* vsum,
                    const void* sc, void* o, int bh, int tq, int tk, int d,
                    int bk, float sm_scale, int quant_w, float wnb,
                    float wpb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!key_blocks_ok(tk, bk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t *qi = (const int8_t*)q8, *ki = (const int8_t*)k8,
               *vi = (const int8_t*)v8;
  const float *qsf = (const float*)qsum, *ksf = (const float*)ksum,
              *scf = (const float*)sc;
  const int* vsi = (const int*)vsum;
  float* of = (float*)o;
#define TFMQ_I8(NC)                                                        \
  return quant_w ? launch_i8<NC, true>(qi, ki, vi, qsf, ksf, vsi, scf, of, \
                                       bh, tq, tk, d, bk, sm_scale, wnb,  \
                                       wpb, s)                             \
                 : launch_i8<NC, false>(qi, ki, vi, qsf, ksf, vsi, scf,   \
                                        of, bh, tq, tk, d, bk, sm_scale,  \
                                        wnb, wpb, s)
  if (d <= 64) TFMQ_I8(2);
  if (d <= 160) TFMQ_I8(5);
  if (d <= 384) TFMQ_I8(12);
#undef TFMQ_I8
  return (int)cudaErrorInvalidValue;
}

// The fqk pre-pass alone: kf (bh, tkp, dp) bf16, and vf (bh, tkp, dp)
// bf16 or (int8_pv) vt (bh, dp, tkp) int8 with vpart (bh, tkp / 64, dp)
// int32; dp = the padded head dim, tkp = tk rounded up to 64.
int tfmq_fqk_prepass(const void* k, const void* v, const void* sc, void* kf,
                     void* vf, void* vt, void* vpart, int bh, int tk, int d,
                     int dp, int tkp, int int8_pv, float knb, float kpb,
                     float vnb, float vpb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bh <= 0 || bh > 65535 || tk <= 0 || dp != fqk_dp(d) ||
      tkp != (tk + FQK_KPAD - 1) / FQK_KPAD * FQK_KPAD)
    return (int)cudaErrorInvalidValue;
  const FqkRanges rg = {0.f, 0.f, knb, kpb, vnb, vpb, 0.f, 0.f};
  dim3 grid(tkp / FQK_KPAD, (dp + FQK_PD - 1) / FQK_PD, bh);
  fqk_prepass_kernel<<<grid, FQK_PRE_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)sc,
      (__nv_bfloat16*)kf, (__nv_bfloat16*)vf, (int8_t*)vt, (int*)vpart, tk,
      tkp, d, dp, int8_pv, rg);
  return (int)cudaGetLastError();
}

// Pre-pass and main kernel on the caller's scratch (see above). Mode 0: no
// softmax quantizer; 1: its levels on bf16 products; 2: int8_pv.
int tfmq_flash_fqk(const void* q, const void* k, const void* v,
                   const void* sc, void* o, void* kf, void* vf, void* vt,
                   void* vpart, int bh, int tq, int tk, int d, int dp,
                   int tkp, int bk, float sm_scale, int mode, int zp_zero,
                   float qnb, float qpb, float knb, float kpb, float vnb,
                   float vpb, float wnb, float wpb, int device,
                   void* stream) {
  if (!key_blocks_ok(tk, bk) || bk % FQK_KPAD || mode < 0 || mode > 2 ||
      tq <= 0)
    return (int)cudaErrorInvalidValue;
  int err = tfmq_fqk_prepass(k, v, sc, kf, vf, vt, vpart, bh, tk, d, dp,
                             tkp, mode == 2, knb, kpb, vnb, vpb, device,
                             stream);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int npre = tkp / FQK_KPAD;
  const __nv_bfloat16 *qb = (const __nv_bfloat16*)q,
                      *kfb = (const __nv_bfloat16*)kf,
                      *vfb = (const __nv_bfloat16*)vf;
  const int8_t* vti = (const int8_t*)vt;
  const int* vp = (const int*)vpart;
  const float* scf = (const float*)sc;
  __nv_bfloat16* ob = (__nv_bfloat16*)o;
  const FqkRanges rg = {qnb, qpb, knb, kpb, vnb, vpb, wnb, wpb};
#define TFMQ_FQK(DP)                                                        \
  return mode == 0 ? launch_fqk<DP, 0>(qb, kfb, vfb, vti, vp, scf, ob, bh,  \
                                       tq, tk, tkp, d, bk, npre, sm_scale,  \
                                       zp_zero, rg, s)                      \
         : mode == 1 ? launch_fqk<DP, 1>(qb, kfb, vfb, vti, vp, scf, ob, bh, \
                                         tq, tk, tkp, d, bk, npre, sm_scale, \
                                         zp_zero, rg, s)                    \
                     : launch_fqk<DP, 2>(qb, kfb, vfb, vti, vp, scf, ob, bh, \
                                         tq, tk, tkp, d, bk, npre, sm_scale, \
                                         zp_zero, rg, s)
  if (dp == 48) TFMQ_FQK(48);
  if (dp == 80) TFMQ_FQK(80);
  if (dp == 160) TFMQ_FQK(160);
  if (dp == 384) TFMQ_FQK(384);
#undef TFMQ_FQK
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
