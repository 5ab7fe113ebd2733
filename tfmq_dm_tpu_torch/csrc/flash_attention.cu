// Flash-attention kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see ops/flash_attention.py).
//
// Counterparts of the Pallas kernels in tfmq_dm_tpu/ops/flash_attention.py:
//   tfmq_flash_f32  mode 0 (fp)      <- _fp_kernel
//                   mode 1 (pquant)  <- _quant_kernel
//   tfmq_flash_int8 (int8)           <- _int8_kernel
//   tfmq_flash_fqk  (fqk)            <- _fqk_kernel
//
// Layout: (B*H, T, D) row-major, no tile padding in device memory; the
// ragged key and query edges are masked in the kernel, and a head dim
// that is not a multiple of 4 (f32) or 16 (int8) is zero-filled in
// shared memory only.
//
// Blocking. A block holds 32 query rows (8 warps x 4 rows) and walks the
// keys in tiles of 32, one key per lane: a lane computes the 4 scores of
// its key against its warp's rows, the warp reduces row max and sum with
// shuffles, and for P @ V each lane owns the head-dim columns lane + 32 i
// of its warp's 4 rows (the accumulators stay in registers; D <= 384).
// The TPU kernels' large VMEM tiles (512 x 2048) become small tiles in
// shared memory: the f32 kernel needs 145 KB at D = 384 (dynamic shared
// memory), the int8 kernel 37 KB.
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
// fqk (the bf16 fast deploy): q/k/v arrive in bf16 and are fake-quantized
// as each tile is loaded (_fq: f32 q/dq, then bf16), into f32 shared
// memory; the products of two bf16 values are exact in f32, so the scalar
// FMA products equal bf16 matrix products with f32 sums up to order. The
// TPU kernel fake-quantizes k/v once per row into VMEM; here each block
// fake-quantizes the tiles it loads, which gives the same values. Always
// two passes: p (bf16), the softmax quantizer's levels, or (int8_pv)
// integer PV on p levels and v codes with exact rank-1 corrections.
//
// What bounds them: at cin256 (B*H = 4, T = 1024, D = 384) each product
// is 3.2 GFLOP and q/k/v/o move 25 MB, so the card's bound is ~7.5 us of
// memory traffic. These kernels run their products on the FP32/INT32
// pipes with scalar FMA / dp4a from shared memory, far from that bound;
// tensor-core tiles (mma.sync / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// f32 operands: mode fp (online softmax) and pquant (two passes)
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

template <int NC, bool PQ>
__global__ void __launch_bounds__(NTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dz,
                 float* __restrict__ o, int tq, int tk, int d, int bk,
                 float sm_scale, float nb, float pb, int zp_zero) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) & ~3;
  const int ksd = dp + 4;  // float4 reads by 32 lanes hit 32 banks
  float* qs = smem;
  float* ks = qs + BQ * dp;
  float* vs = ks + BK * ksd;
  float* mblk = vs + BK * dp;   // [BQ][MAX_KB] running max per key block
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

  // pass 1: online row max and denominator (fp: and the output)
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_tile(ks, ksd, kb, kt * BK, tk, d, dp);
    if (!PQ) load_tile(vs, dp, vb, kt * BK, tk, d, dp);
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
      if (!PQ) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      }
    }
    if (PQ) record_block_max(mblk, m, warp, lane, kt, nkt, bk);
    if (!PQ) pv_f32<NC>(acc, s, vs, dp, d, lane, min(BK, tk - kt * BK));
  }

  float scale[RPW] = {};
  if (PQ) {
    // pass 2: recompute s, quantize the exact probabilities, P @ V
    const float delta = dz[0], zp = dz[1];
    float inv[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) inv[r] = 1.f / (l[r] * delta);
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      load_tile(ks, ksd, kb, kt * BK, tk, d, dp);
      load_tile(vs, dp, vb, kt * BK, tk, d, dp);
      __syncthreads();
      float s[RPW];
      scores_f32<NC>(s, qs, ks, dp, ksd, warp, lane, kt * BK + lane, tk,
                     sm_scale);
      const bool valid = kt * BK + lane < tk;
      const int kb = kt * BK / bk;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float mb = mblk[(warp * RPW + r) * MAX_KB + kb];
        const float e = expf(s[r] - mb);
        const float x =
            rintf(__fmul_rn(e, __fmul_rn(expf(mb - m[r]), inv[r])));
        const float lv = zp_zero ? fminf(x, pb)
                                 : fminf(fmaxf(x + zp, nb), pb) - zp;
        s[r] = valid ? lv : 0.f;
      }
      pv_f32<NC>(acc, s, vs, dp, d, lane, min(BK, tk - kt * BK));
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) scale[r] = delta;
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= tq) continue;
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = PQ ? scale[r] * acc[r][i] : acc[r][i] / l[r];
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

// 32 rows from row0 of a (rows, d) bf16 matrix, fake-quantized, as f32
// with row stride `stride`; zero past the last row and past column d
__device__ __forceinline__ void load_fq_tile(float* dst, int stride,
                                             const __nv_bfloat16* src,
                                             int row0, int rows, int d,
                                             int dp, float delta, float zp,
                                             float nb, float pb) {
  const float inv = 1.f / delta;
  for (int idx = threadIdx.x; idx < 32 * dp; idx += NTHREADS) {
    const int r = idx / dp, c = idx - r * dp;
    const int row = row0 + r;
    dst[r * stride + c] =
        (row < rows && c < d)
            ? fq_value(__bfloat162float(src[(size_t)row * d + c]), delta,
                       inv, zp, nb, pb)
            : 0.f;
  }
}

// the same rows as centered int8 codes clip(round(x / delta) + zp) - 128
__device__ __forceinline__ void load_code_tile(int8_t* dst, int stride,
                                               const __nv_bfloat16* src,
                                               int row0, int rows, int d,
                                               int dp, float delta, float zp,
                                               float nb, float pb) {
  const float inv = 1.f / delta;
  for (int idx = threadIdx.x; idx < 32 * dp; idx += NTHREADS) {
    const int r = idx / dp, c = idx - r * dp;
    const int row = row0 + r;
    int8_t code = 0;
    if (row < rows && c < d) {
      const float x = __bfloat162float(src[(size_t)row * d + c]);
      const float xq =
          fminf(fmaxf(__fadd_rn(rintf(__fmul_rn(x, inv)), zp), nb), pb);
      code = (int8_t)(int)(xq - 128.f);
    }
    dst[r * stride + c] = code;
  }
}

// MODE 0: p cast to bf16; 1: softmax-quantizer levels (p_q - zw);
// 2 (int8_pv): integer P @ V on p_q - 128 and v codes, exact corrections
template <int NC, int MODE>
__global__ void __launch_bounds__(NTHREADS)
flash_fqk_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ sc,
                 __nv_bfloat16* __restrict__ o, int tq, int tk, int d,
                 int bk, float sm_scale, int zp_zero, FqkRanges rg) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) & ~3;
  const int ksd = dp + 4;
  float* qs = smem;
  float* ks = qs + BQ * dp;
  float* mblk = ks + BK * ksd;          // [BQ][MAX_KB]
  float* vs = mblk + BQ * MAX_KB;       // f32 values, or int8 codes
  int8_t* vs8 = reinterpret_cast<int8_t*>(vs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
  const __nv_bfloat16* kb_ = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  // sc = [dq, zq, dk, zk, dv, zv, dw, zw]
  const float dk = sc[2], zk = sc[3], dv = sc[4], zv = sc[5];
  const float dw = sc[6], zw = sc[7];
  load_fq_tile(qs, dp, qb, q0, tq, d, dp, sc[0], sc[1], rg.qnb, rg.qpb);

  float m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  const int nkt = (tk + BK - 1) / BK;

  // pass 1: row max, denominator and the block maxes
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_fq_tile(ks, ksd, kb_, kt * BK, tk, d, dp, dk, zk, rg.knb, rg.kpb);
    __syncthreads();
    float s[RPW];
    scores_f32<NC>(s, qs, ks, dp, ksd, warp, lane, kt * BK + lane, tk,
                   sm_scale);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(expf(s[r] - m_new));
      m[r] = m_new;
    }
    record_block_max(mblk, m, warp, lane, kt, nkt, bk);
  }

  float inv[RPW], acc[RPW][NC];
  int pvi[RPW][MODE == 2 ? NC : 1], psum[RPW], vsum[MODE == 2 ? NC : 1];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    inv[r] = MODE == 0 ? 1.f / l[r] : 1.f / (l[r] * dw);
    psum[r] = 0;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (MODE == 2 ? NC : 1); ++i) pvi[r][i] = 0;
  }
#pragma unroll
  for (int i = 0; i < (MODE == 2 ? NC : 1); ++i) vsum[i] = 0;

  // pass 2: recompute s, p against its block's max, P @ V
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_fq_tile(ks, ksd, kb_, kt * BK, tk, d, dp, dk, zk, rg.knb, rg.kpb);
    if (MODE == 2)
      load_code_tile(vs8, dp, vb, kt * BK, tk, d, dp, dv, zv, rg.vnb,
                     rg.vpb);
    else
      load_fq_tile(vs, dp, vb, kt * BK, tk, d, dp, dv, zv, rg.vnb, rg.vpb);
    __syncthreads();
    float s[RPW];
    scores_f32<NC>(s, qs, ks, dp, ksd, warp, lane, kt * BK + lane, tk,
                   sm_scale);
    const bool valid = kt * BK + lane < tk;
    const int kb = kt * BK / bk;
    int p8[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float mb = mblk[(warp * RPW + r) * MAX_KB + kb];
      const float x = __fmul_rn(expf(s[r] - mb),
                                __fmul_rn(expf(mb - m[r]), inv[r]));
      p8[r] = 0;
      if (MODE == 0) {
        s[r] = valid ? bf16r(x) : 0.f;
      } else {
        const float xr = rintf(x);
        const float pq =
            zp_zero ? fminf(xr, rg.wpb)
                    : fminf(fmaxf(__fadd_rn(xr, zw), rg.wnb), rg.wpb);
        if (MODE == 1) {
          s[r] = valid ? (zp_zero ? pq : __fsub_rn(pq, zw)) : 0.f;
        } else {
          p8[r] = valid ? (int)(pq - 128.f) : 0;
          psum[r] += warp_sum_int(p8[r]);
        }
      }
    }
    const int nkeys = min(BK, tk - kt * BK);
    if constexpr (MODE == 2) {
      for (int j = 0; j < nkeys; ++j) {
        int pj[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) pj[r] = __shfl_sync(FULL, p8[r], j);
        const int8_t* vr = vs8 + j * dp;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int vv = vr[min(lane + 32 * i, dp - 1)];
          vsum[i] += vv;
#pragma unroll
          for (int r = 0; r < RPW; ++r) pvi[r][i] += pj[r] * vv;
        }
      }
    } else {
      pv_f32<NC>(acc, s, vs, dp, d, lane, nkeys);
    }
  }

  const long long zvc = __float2ll_rn(zv - 128.f);
  const long long wz = 128 - __float2ll_rn(zw);
  const float dwdv = __fmul_rn(dw, dv);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= tq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int cc = lane + 32 * i;
      if (cc >= d) continue;
      float val;
      if constexpr (MODE == 2) {
        // sum over real keys of (p_q - zw)(v_q - zv), exact in 64 bits
        const long long corr = (long long)pvi[r][i] -
                               zvc * (long long)psum[r] +
                               wz * (long long)vsum[i] - wz * zvc * tk;
        val = __fmul_rn(dwdv, (float)corr);
      } else if constexpr (MODE == 1) {
        val = __fmul_rn(dw, acc[r][i]);
      } else {
        val = acc[r][i];
      }
      orow[cc] = __float2bfloat16_rn(val);
    }
  }
}

bool key_blocks_ok(int tk, int bk) {
  return bk > 0 && bk % BK == 0 && (tk + bk - 1) / bk <= MAX_KB;
}

size_t f32_smem(int d) {
  const int dp = (d + 3) & ~3;
  return sizeof(float) * (BQ * dp + BK * (dp + 4) + BK * dp + BQ * MAX_KB);
}

size_t i8_smem(int d) {
  const int dp = (d + 15) & ~15;
  return sizeof(int) * (BQ * (dp / 4) + BK * (dp / 4 + 4) + BQ * MAX_KB) +
         BK * dp;
}

size_t fqk_smem(int d) {
  const int dp = (d + 3) & ~3;
  return sizeof(float) * (BQ * dp + BK * (dp + 4) + BQ * MAX_KB + BK * dp);
}

template <int NC, int MODE>
int launch_fqk(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const float* sc, __nv_bfloat16* o,
               int bh, int tq, int tk, int d, int bk, float sm_scale,
               int zp_zero, FqkRanges rg, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fqk_kernel<NC, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fqk_smem(32 * NC));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fqk_kernel<NC, MODE><<<grid, NTHREADS, fqk_smem(d), stream>>>(
      q, k, v, sc, o, tq, tk, d, bk, sm_scale, zp_zero, rg);
  return (int)cudaGetLastError();
}

template <int NC, bool PQ>
int launch_f32(const float* q, const float* k, const float* v,
               const float* dz, float* o, int bh, int tq, int tk, int d,
               int bk, float sm_scale, float nb, float pb, int zp_zero,
               cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<NC, PQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)f32_smem(32 * NC));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_f32_kernel<NC, PQ><<<grid, NTHREADS, f32_smem(d), stream>>>(
      q, k, v, dz, o, tq, tk, d, bk, sm_scale, nb, pb, zp_zero);
  return (int)cudaGetLastError();
}

template <int NC, bool PQ>
int launch_i8(const int8_t* q8, const int8_t* k8, const int8_t* v8,
              const float* qsum, const float* ksum, const int* vsum,
              const float* sc, float* o, int bh, int tq, int tk, int d,
              int bk, float sm_scale, float wnb, float wpb,
              cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_i8_kernel<NC, PQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)i8_smem(32 * NC));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
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
#define TFMQ_F32(NC)                                                       \
  return pquant ? launch_f32<NC, true>(qf, kf, vf, dzf, of, bh, tq, tk, d, \
                                       bk, sm_scale, nb, pb, zp_zero, s)   \
                : launch_f32<NC, false>(qf, kf, vf, dzf, of, bh, tq, tk,  \
                                        d, bk, sm_scale, nb, pb, zp_zero, \
                                        s)
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

int tfmq_flash_fqk(const void* q, const void* k, const void* v,
                   const void* sc, void* o, int bh, int tq, int tk, int d,
                   int bk, float sm_scale, int mode, int zp_zero, float qnb,
                   float qpb, float knb, float kpb, float vnb, float vpb,
                   float wnb, float wpb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!key_blocks_ok(tk, bk) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16 *qb = (const __nv_bfloat16*)q,
                      *kb = (const __nv_bfloat16*)k,
                      *vb = (const __nv_bfloat16*)v;
  const float* scf = (const float*)sc;
  __nv_bfloat16* ob = (__nv_bfloat16*)o;
  const FqkRanges rg = {qnb, qpb, knb, kpb, vnb, vpb, wnb, wpb};
#define TFMQ_FQK(NC)                                                       \
  return mode == 0 ? launch_fqk<NC, 0>(qb, kb, vb, scf, ob, bh, tq, tk, d, \
                                       bk, sm_scale, zp_zero, rg, s)       \
         : mode == 1 ? launch_fqk<NC, 1>(qb, kb, vb, scf, ob, bh, tq, tk,  \
                                         d, bk, sm_scale, zp_zero, rg, s)  \
                     : launch_fqk<NC, 2>(qb, kb, vb, scf, ob, bh, tq, tk,  \
                                         d, bk, sm_scale, zp_zero, rg, s)
  if (d <= 64) TFMQ_FQK(2);
  if (d <= 160) TFMQ_FQK(5);
  if (d <= 384) TFMQ_FQK(12);
#undef TFMQ_FQK
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
