// Packed-int4 weight kernels for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes; see ops/int4_kernels.py).
//
// Counterparts of the Pallas kernels in tfmq_dm_tpu/ops/pallas_kernels.py:
//   tfmq_int4_linear  <- int4_matmul_dequant (_int4_mm_kernel)
//   tfmq_int4_conv2d  <- int4_conv2d_dequant (_int4_conv_kernel)
//
// Packing (the port's own, ops/int4_kernels.pack_int4): centered codes in
// [-8, 7], two adjacent output channels per byte along the last axis:
// byte j of a row holds channel 2j in the low nibble and 2j+1 in the high
// nibble. A warp reading 32 consecutive bytes of one row reads 64
// neighbouring output channels, so weight loads are coalesced.
//
// Rounding points follow the TPU kernels exactly; only the f32 summation
// order differs:
//   linear: x -> bf16; w = bf16(bf16(q - zp_c) * bf16(delta)) (bf16
//           arithmetic at each step, pallas_kernels.py:262-264)
//   conv:   x arrives bf16; w = bf16(f32((q - zp_c) * delta)) (f32
//           dequant, one rounding to bf16, pallas_kernels.py:483-485)
// Products of two bf16 values are exact in f32; both kernels accumulate
// them in f32 and then add the f32 bias.
//
// What bounds them on this card. The linear at cin256's transformer
// shapes (M = tokens x batch up to 4096, K 384-3840, N up to 7680) is
// bound by its f32 output bytes and, close behind, by its bf16 products;
// at CIFAR-10's M = 8 and cin256's per-image embedding projections (M 4)
// by the packed weight bytes and launch latency. Its first version read
// and dequantized each packed byte once per 8 rows of x on the FP32 pipe
// (36.9x torch.matmul at M 4096). This design runs the products on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators) over
// a block tile of 128 x 128 outputs (16 x 64 for M <= 64), so each packed
// byte is read and dequantized once per block tile into a bf16 [k][n]
// tile (ldmatrix.trans gives the B fragments); x is converted to bf16
// once on its way into shared memory. The raw tiles (x in f32, the
// packed bytes) come by cp.async in a three-stage ring, and the bf16
// tiles are double-buffered: a K step converts the next step's tiles
// while it runs its own products, under one barrier a step. A block first
// tabulates the 16 dequantized values of each of its channels (the
// arithmetic above), so a packed byte costs two table lookups (a thread
// owns one byte column: byte loads, lookups and word stores without bank
// conflicts). Two blocks of the large tile fit an SM. Where the output
// tiles would leave most SMs idle, K is split over blocks; the partial
// sums go to a workspace and a second kernel adds them in split order,
// so two calls give bit-identical outputs (no atomics). Every 32-byte
// sector of the output is written whole (float2 stores of the
// accumulator fragments). The conv (implicit GEMM, M = B*H*W, K =
// 9*Cin) is bound by arithmetic and runs on the tensor cores (mma.sync),
// one tile step at a time without a copy pipeline. Times against the
// bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sign-extended nibbles of one packed byte
__device__ __forceinline__ float lo_code(uint8_t b) {
  return (float)((((int)b & 15) ^ 8) - 8);
}
__device__ __forceinline__ float hi_code(uint8_t b) {
  return (float)((((int)b >> 4) ^ 8) - 8);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared, asynchronously; the bytes past `bytes` (0 to
// 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// int4 linear: out (M, N) = bf16(x) (M, K) @ dequant(w) (K, N) + bias
// Block tile BM x BN outputs, K steps of LIN_BK, WM x WN warps; blockIdx.z
// takes the K range [z * kchunk, (z + 1) * kchunk). One split: bias added,
// out written. Several: the partial sums go to ws[z] (M, N) and
// int4_linear_reduce adds them.
// Each K step's x tile (f32) and packed-byte tile arrive by cp.async in a
// LIN_STAGES ring; the step converts its stage into the bf16 tiles As
// [m][k] and Bs [k][n] (each packed byte dequantized once, bf16(bf16(q -
// zp) * delta)), then runs the products from them.
// ---------------------------------------------------------------------------

constexpr int LIN_BK = 32;
constexpr int LIN_STAGES = 3;

template <int BM, int BN, int WM, int WN>
struct LinTile {
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  static constexpr int MI = TM / 16, NJ = TN / 8;    // mma tiles per warp
  static constexpr int AP = LIN_BK + 8;  // bf16 pitch of As: 80 bytes
  static constexpr int BP = BN + 8;      // bf16 pitch of Bs: rows 16 B apart
                                         // mod 128 B, conflict-free
  static constexpr int A_IT = BM * LIN_BK / 4 / THREADS;   // f32 x4 / thread
  // the B tile: a thread owns one byte column (two output channels) and
  // dequantizes B_ROWS of its rows, every B_RSTEP-th, by table lookup
  static constexpr int B_RSTEP = THREADS / (BN / 2);
  static constexpr int B_ROWS = LIN_BK / B_RSTEP;
  static constexpr int XCH = BM * LIN_BK / 4;     // 16-byte chunks of x
  static constexpr int WCH = LIN_BK * BN / 32;    // 16-byte chunks of bytes
  // shared memory: the raw ring, then As[2], Bs[2] and the dequant table
  static constexpr int X_BYTES = BM * LIN_BK * 4;
  static constexpr int W_BYTES = LIN_BK * BN / 2;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int A_OFF = LIN_STAGES * STAGE;
  static constexpr int B_OFF = A_OFF + 2 * BM * AP * 2;
  static constexpr int T_OFF = B_OFF + 2 * LIN_BK * BP * 2;
  static constexpr int SMEM = T_OFF + 16 * BN * 2;
  static_assert(MI >= 1 && NJ % 2 == 0, "warp tile");
  static_assert(A_IT >= 1 && A_IT * THREADS * 4 == BM * LIN_BK, "A loader");
  static_assert(B_RSTEP >= 1 && B_ROWS * B_RSTEP == LIN_BK, "B loader");
  static_assert(STAGE % 16 == 0 && B_OFF % 16 == 0 && T_OFF % 16 == 0,
                "alignment");
};

template <int BM, int BN, int WM, int WN, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
int4_linear_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ wp,
                   const float* __restrict__ delta,
                   const float* __restrict__ zpc,
                   const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ ws, int M,
                   int K, int N, int kchunk, int vec_a, int vec_b) {
  using T = LinTile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  typedef __nv_bfloat16 ATile[T::AP];
  typedef __nv_bfloat16 BTile[T::BP];
  ATile* As = reinterpret_cast<ATile*>(smem + T::A_OFF);
  BTile* Bs = reinterpret_cast<BTile*>(smem + T::B_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int nbytes = (N + 1) >> 1;
  const int wm = (warp / WN) * T::TM, wn = (warp % WN) * T::TN;

  // the dequant table: lut[v][n] = bf16(bf16(q - zp) * delta) of channel
  // n_base + n for the code q = (v ^ 8) - 8 of nibble v (0 past N), built
  // once per block: each packed byte is then dequantized by two lookups
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem + T::T_OFF);
  for (int i = tid; i < 16 * BN; i += T::THREADS) {
    const int v = i / BN, n = n_base + i % BN;
    uint32_t w = 0;
    if (n < N) {
      const float q = (float)((v ^ 8) - 8);
      w = __bfloat16_as_ushort(__float2bfloat16_rn(
          bf16r(q - bf16r(zpc[n])) * bf16r(delta[n])));
    }
    lut[i] = (uint16_t)w;
  }
  // this thread's byte column of the B tile (channels 2 jbl, 2 jbl + 1)
  const int jbl = tid % (BN / 2), b_r0 = tid / (BN / 2);

  // step k0 -> ring stage st: x [BM][LIN_BK] f32 and the packed bytes
  // [LIN_BK][BN / 2], zero past M, K and N
  auto issue = [&](int st, int k0) {
    float* xs = reinterpret_cast<float*>(smem + st * T::STAGE);
    uint8_t* wsb = smem + st * T::STAGE + T::X_BYTES;
    for (int id = tid; id < T::XCH; id += T::THREADS) {
      const int r = id / (LIN_BK / 4), c = (id % (LIN_BK / 4)) * 4;
      const int m = m_base + r, k = k0 + c;
      float* dst = xs + r * LIN_BK + c;
      if (vec_a) {
        const int bytes = m < M ? 4 * max(0, min(4, k_end - k)) : 0;
        cp_async16(dst, bytes ? x + (size_t)m * K + k : x, bytes);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[e] = (m < M && k + e < k_end) ? x[(size_t)m * K + k + e] : 0.f;
      }
    }
    for (int id = tid; id < T::WCH; id += T::THREADS) {
      const int r = id / (BN / 32), cb = (id % (BN / 32)) * 16;
      const int k = k0 + r, jb = (n_base >> 1) + cb;
      uint8_t* dst = wsb + r * (BN / 2) + cb;
      if (vec_b) {
        const int bytes = k < k_end ? max(0, min(16, nbytes - jb)) : 0;
        cp_async16(dst, bytes ? wp + (size_t)k * nbytes + jb : wp, bytes);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (k < k_end && jb + e < nbytes)
                       ? wp[(size_t)k * nbytes + jb + e]
                       : (uint8_t)0;
      }
    }
  };

  // ring stage st of step k0 -> As (bf16) and Bs (dequantized, 0 past K
  // and N)
  auto convert = [&](int st, int k0, int buf) {
    ATile* Ab = As + buf * BM;
    BTile* Bb = Bs + buf * LIN_BK;
    const float* xs = reinterpret_cast<const float*>(smem + st * T::STAGE);
    const uint8_t* wsb = smem + st * T::STAGE + T::X_BYTES;
#pragma unroll
    for (int i = 0; i < T::A_IT; ++i) {
      const int id = tid + i * T::THREADS;
      const int r = id / (LIN_BK / 4), c = (id % (LIN_BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(xs + r * LIN_BK + c);
      *reinterpret_cast<uint2*>(&Ab[r][c]) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
#pragma unroll
    for (int i = 0; i < T::B_ROWS; ++i) {
      const int r = b_r0 + i * T::B_RSTEP;
      const uint32_t b = wsb[r * (BN / 2) + jbl];
      const uint32_t w0 = lut[(b & 15u) * BN + 2 * jbl];
      const uint32_t w1 = lut[(b >> 4) * BN + 2 * jbl + 1];
      *reinterpret_cast<uint32_t*>(&Bb[r][2 * jbl]) =
          k0 + r < k_end ? (w0 | (w1 << 16)) : 0u;
    }
  };

  float acc[T::MI][T::NJ][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Steps 0..s+2 are in flight before step s. Step s: wait for step s+1,
  // one barrier (its raw tiles are visible; every warp is done with the
  // products of step s-1, so bf16 buffer (s+1)&1 and ring stage s%3 are
  // free), convert step s+1, refill stage s%3 with step s+3, and run the
  // products of step s: conversion and products of two steps overlap.
  static_assert(LIN_STAGES == 3, "the loop below keeps three steps ahead");
  const int nsteps = (k_end - k_begin + LIN_BK - 1) / LIN_BK;
  auto step_k = [&](int s) { return k_begin + s * LIN_BK; };
  issue(0, step_k(0));
  cp_async_commit();
  if (nsteps > 1) issue(1, step_k(1));
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // step 0 and the table
  convert(0, step_k(0), 0);
  if (nsteps > 2) issue(2, step_k(2));
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s + 1 < nsteps) convert((s + 1) % 3, step_k(s + 1), (s + 1) & 1);
    if (s + 3 < nsteps) issue(s % 3, step_k(s + 3));
    cp_async_commit();
    const ATile* Ab = As + (s & 1) * BM;
    const BTile* Bb = Bs + (s & 1) * LIN_BK;
#pragma unroll
    for (int kk = 0; kk < LIN_BK; kk += 16) {
      uint32_t af[T::MI][4], bfr[T::NJ][2];
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
        ldsm_x4(af[i], &Ab[wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                          [kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < T::NJ; j += 2) {
        uint32_t r4[4];
        ldsm_x4_trans(r4, &Bb[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                             [wn + j * 8 + (lane >> 4) * 8]);
        bfr[j][0] = r4[0];
        bfr[j][1] = r4[1];
        bfr[j + 1][0] = r4[2];
        bfr[j + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
#pragma unroll
        for (int j = 0; j < T::NJ; ++j)
          mma_bf16_16816(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  float* dst = split ? ws + (size_t)blockIdx.z * M * N : out;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      float* row = dst + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        const int n = n_base + wn + j * 8 + 2 * t4;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (!split && bias) {
          v0 += n < N ? bias[n] : 0.f;
          v1 += n + 1 < N ? bias[n + 1] : 0.f;
        }
        if (pair && n + 1 < N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < N) row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
      }
    }
  }
}

// out = sum over the splits z = 0, 1, ... of ws[z] (in that order) + bias
__global__ void int4_linear_reduce(const float* __restrict__ ws,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out, int M, int N,
                                   int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    out[i] = s + (bias ? bias[i % N] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// int4 conv2d, stride 1, NHWC: implicit GEMM with M = B*Ho*Wo output
// pixels, N = Cout, K = KH*KW*Cin, on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulators). Zero padding is applied when
// the activation tile is loaded. K advances one tap and CV_BK input
// channels at a time; the packed weights of that step are dequantized
// into shared memory, transposed to [n][k] for the B fragments.
// Block: CV_BM pixels x CV_BN channels, four warps of 64 x 32 each.
// ---------------------------------------------------------------------------

constexpr int CV_BM = 128;
constexpr int CV_BN = 64;
constexpr int CV_BK = 32;
constexpr int CV_THREADS = 128;
constexpr int CV_LD = CV_BK + 8;  // bf16 row pitch: 80 bytes, no conflicts

__global__ void __launch_bounds__(CV_THREADS)
int4_conv2d_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ wp,
                   const float* __restrict__ delta,
                   const float* __restrict__ zpc,
                   const float* __restrict__ bias,
                   float* __restrict__ out, int B, int H, int W, int Cin,
                   int N, int KH, int KW, int PH, int PW, int Ho, int Wo) {
  __shared__ __align__(16) __nv_bfloat16 As[CV_BM][CV_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[CV_BN][CV_LD];
  __shared__ float ds[CV_BN], zs[CV_BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = B * Ho * Wo;
  const int m_base = blockIdx.x * CV_BM;
  const int n_base = blockIdx.y * CV_BN;
  const int nbytes = (N + 1) >> 1;
  const bool vec = (Cin & 7) == 0;

  if (tid < CV_BN) {
    const int n = n_base + tid;
    ds[tid] = n < N ? delta[n] : 0.f;
    zs[tid] = n < N ? zpc[n] : 0.f;
  }

  // A loader: 4 chunks of 8 channels (16 bytes) per thread; chunk i of
  // this thread covers pixel (tid + i*128) / 4, channels 8*(tid % 4)..+7
  const int a_q = (tid & 3) * 8;
  int a_b[4], a_oh[4], a_ow[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m_base + ((tid + i * CV_THREADS) >> 2);
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / (Ho * Wo);
    const int rem = mm - a_b[i] * Ho * Wo;
    a_oh[i] = rem / Wo;
    a_ow[i] = rem - a_oh[i] * Wo;
  }
  // B loader: one K row, 8 packed bytes = 16 output channels
  const int b_r = tid >> 2;
  const int b_n = (tid & 3) * 16;

  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int tap = 0; tap < KH * KW; ++tap) {
    const int ki = tap / KW, kj = tap - (tap / KW) * KW;
    const uint8_t* wtap = wp + (size_t)tap * Cin * nbytes;
    for (int c0 = 0; c0 < Cin; c0 += CV_BK) {
      __syncthreads();  // previous step's fragments are consumed
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = (tid + i * CV_THREADS) >> 2;
        const int ih = a_oh[i] + ki - PH, iw = a_ow[i] + kj - PW;
        const bool in_ok = a_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W;
        const int c = c0 + a_q;
        const __nv_bfloat16* src =
            x + (((size_t)a_b[i] * H + (in_ok ? ih : 0)) * W +
                 (in_ok ? iw : 0)) * Cin + c;
        if (in_ok && vec && c + 8 <= Cin) {
          *reinterpret_cast<uint4*>(&As[p][a_q]) =
              *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            As[p][a_q + e] = (in_ok && c + e < Cin) ? src[e]
                                                    : __float2bfloat16_rn(0.f);
        }
      }
      const int kr = c0 + b_r;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int nl = b_n + 2 * e;
        const int jb = (n_base + nl) >> 1;
        const uint8_t byte =
            (kr < Cin && jb < nbytes) ? wtap[(size_t)kr * nbytes + jb] : 0;
        // f32 dequant, one rounding to bf16 (pad rows/columns: 0)
        const bool ok = kr < Cin && n_base + nl < N;
        const bool ok1 = kr < Cin && n_base + nl + 1 < N;
        Bs[nl][b_r] = __float2bfloat16_rn(
            ok ? (lo_code(byte) - zs[nl]) * ds[nl] : 0.f);
        Bs[nl + 1][b_r] = __float2bfloat16_rn(
            ok1 ? (hi_code(byte) - zs[nl + 1]) * ds[nl + 1] : 0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CV_BK; kk += 16) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm + i * 16 + g;
          af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4]);
          af[i][1] =
              *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4]);
          af[i][2] =
              *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4 + 8]);
          af[i][3] =
              *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4 + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn + j * 8 + g;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 2 * t4]);
          bf[j][1] =
              *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 2 * t4 + 8]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_base + wn + j * 8 + 2 * t4 + e;
          if (n < N)
            out[(size_t)m * N + n] =
                acc[i][j][2 * h + e] + (bias ? bias[n] : 0.f);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Each entry launches on the given stream (PyTorch's current stream) and
// returns cudaGetLastError() so that a refused launch is reported.

// small != 0: 16 x 64 block tiles (M <= 64), else 128 x 128; splits > 1:
// blockIdx.z over K ranges of kchunk, partial sums in ws (splits, M, N)
int tfmq_int4_linear(const void* x, const void* w_packed, const void* delta,
                     const void* zp_c, const void* bias, void* out, void* ws,
                     int M, int K, int N, int small, int kchunk, int splits,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || K <= 0 || N <= 0 || splits < 1 || kchunk % LIN_BK ||
      (long long)kchunk * (splits - 1) >= K ||
      (long long)kchunk * splits < K || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nbytes = (N + 1) >> 1;
  const int vec_a = (K % 4 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_b = (nbytes % 16 == 0) && ((uintptr_t)w_packed % 16 == 0);
  const float* xf = (const float*)x;
  const uint8_t* wb = (const uint8_t*)w_packed;
  const float *df = (const float*)delta, *zf = (const float*)zp_c,
              *bf = (const float*)bias;
  float *of = (float*)out, *wsf = (float*)ws;
  if (small) {
    using T = LinTile<16, 64, 1, 4>;
    dim3 grid((N + 63) / 64, (M + 15) / 16, splits);
    int4_linear_kernel<16, 64, 1, 4, 4><<<grid, T::THREADS, T::SMEM, s>>>(
        xf, wb, df, zf, bf, of, wsf, M, K, N, kchunk, vec_a, vec_b);
  } else {
    using T = LinTile<128, 128, 2, 4>;
    static tfmq::SmemAttr attr;
    const int e = tfmq::raise_smem(int4_linear_kernel<128, 128, 2, 4, 2>,
                                   attr, T::SMEM);
    if (e) return e;
    dim3 grid((N + 127) / 128, (M + 127) / 128, splits);
    int4_linear_kernel<128, 128, 2, 4, 2><<<grid, T::THREADS, T::SMEM, s>>>(
        xf, wb, df, zf, bf, of, wsf, M, K, N, kchunk, vec_a, vec_b);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  int4_linear_reduce<<<blocks, 256, 0, s>>>(wsf, bf, of, M, N, splits);
  return (int)cudaGetLastError();
}

int tfmq_int4_conv2d(const void* x, const void* w_packed, const void* delta,
                     const void* zp_c, const void* bias, void* out, int B,
                     int H, int W, int Cin, int N, int KH, int KW, int PH,
                     int PW, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Ho = H + 2 * PH - KH + 1;
  const int Wo = W + 2 * PW - KW + 1;
  const int M = B * Ho * Wo;
  dim3 grid((M + CV_BM - 1) / CV_BM, (N + CV_BN - 1) / CV_BN);
  int4_conv2d_kernel<<<grid, CV_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w_packed,
      (const float*)delta, (const float*)zp_c, (const float*)bias,
      (float*)out, B, H, W, Cin, N, KH, KW, PH, PW, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // extern "C"
