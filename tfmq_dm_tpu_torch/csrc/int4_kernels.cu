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
// What bounds them on this card: at the CIFAR-10 serving shapes the linear
// (M = batch <= 64, K = 512) is bound by its packed weight bytes, and at
// M = 8 mostly by launch latency: it stays a scalar-FMA kernel that reads
// each packed byte once per 8 rows. The conv (implicit GEMM, M = B*H*W,
// K = 9*Cin) is bound by arithmetic and runs on the tensor cores
// (mma.sync, bf16 operands, f32 accumulators), one tile step at a time
// without a copy pipeline; times against the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// int4 linear: out (M, N) = bf16(x) (M, K) @ dequant(w) (K, N) + bias
// Block: 32 packed byte columns (64 outputs) x LIN_MT rows of x; the eight
// warps split K and their partial sums are added in shared memory.
// ---------------------------------------------------------------------------

constexpr int LIN_MT = 8;    // rows of x per block
constexpr int LIN_KC = 512;  // K chunk staged in shared memory
constexpr int LIN_TX = 32;   // packed byte columns per block
constexpr int LIN_TY = 8;    // warps splitting K

__global__ void __launch_bounds__(LIN_TX * LIN_TY)
int4_linear_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ wp,
                   const float* __restrict__ delta,
                   const float* __restrict__ zpc,
                   const float* __restrict__ bias,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[LIN_MT][LIN_KC];
  __shared__ float part[LIN_TY][LIN_MT][2 * LIN_TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * LIN_TX + tx;
  const int nbytes = (N + 1) >> 1;
  const int jb = blockIdx.x * LIN_TX + tx;
  const int m0 = blockIdx.y * LIN_MT;
  const int n0 = 2 * jb, n1 = 2 * jb + 1;
  const bool ok0 = n0 < N, ok1 = n1 < N;
  const float d0 = ok0 ? bf16r(delta[n0]) : 0.f;
  const float z0 = ok0 ? bf16r(zpc[n0]) : 0.f;
  const float d1 = ok1 ? bf16r(delta[n1]) : 0.f;
  const float z1 = ok1 ? bf16r(zpc[n1]) : 0.f;

  float acc0[LIN_MT], acc1[LIN_MT];
#pragma unroll
  for (int r = 0; r < LIN_MT; ++r) acc0[r] = acc1[r] = 0.f;

  for (int kc = 0; kc < K; kc += LIN_KC) {
    const int kn = min(LIN_KC, K - kc);
    for (int i = tid; i < LIN_MT * LIN_KC; i += LIN_TX * LIN_TY) {
      const int r = i / LIN_KC, c = i - r * LIN_KC;
      const int m = m0 + r;
      xs[r][c] = (m < M && c < kn) ? bf16r(x[(size_t)m * K + kc + c]) : 0.f;
    }
    __syncthreads();
    if (ok0) {
      for (int c = ty; c < kn; c += LIN_TY) {
        const uint8_t b = wp[(size_t)(kc + c) * nbytes + jb];
        const float w0 = bf16r(bf16r(lo_code(b) - z0) * d0);
        const float w1 = bf16r(bf16r(hi_code(b) - z1) * d1);
#pragma unroll
        for (int r = 0; r < LIN_MT; ++r) {
          const float xv = xs[r][c];
          acc0[r] = fmaf(xv, w0, acc0[r]);
          acc1[r] = fmaf(xv, w1, acc1[r]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < LIN_MT; ++r) {
    part[ty][r][2 * tx] = acc0[r];
    part[ty][r][2 * tx + 1] = acc1[r];
  }
  __syncthreads();
  for (int i = tid; i < LIN_MT * 2 * LIN_TX; i += LIN_TX * LIN_TY) {
    const int r = i / (2 * LIN_TX), c = i - r * (2 * LIN_TX);
    const int m = m0 + r, n = blockIdx.x * 2 * LIN_TX + c;
    if (m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < LIN_TY; ++y) s += part[y][r][c];
      out[(size_t)m * N + n] = s + (bias ? bias[n] : 0.f);
    }
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

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

int tfmq_int4_linear(const void* x, const void* w_packed, const void* delta,
                     const void* zp_c, const void* bias, void* out, int M,
                     int K, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nbytes = (N + 1) >> 1;
  dim3 grid((nbytes + LIN_TX - 1) / LIN_TX, (M + LIN_MT - 1) / LIN_MT);
  dim3 block(LIN_TX, LIN_TY);
  int4_linear_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)w_packed, (const float*)delta,
      (const float*)zp_c, (const float*)bias, (float*)out, M, K, N);
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
