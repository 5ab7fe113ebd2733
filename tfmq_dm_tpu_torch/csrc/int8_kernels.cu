// Exact int8 GEMM for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes; see ops/int8_kernels.py).
//
// Counterpart of the Pallas kernel in tfmq_dm_tpu/ops/pallas_kernels.py:
//   tfmq_int8_gemm, f32 / bf16 epilogue  <- int8_matmul_pre
//                                           (_int8_mm_pre_kernel)
//   tfmq_int8_gemm, int32 accumulator    <- the int32 products that the
//                                           JAX package leaves to XLA
//                                           (int_ops.int8_conv2d's conv
//                                           on an im2col, and the
//                                           attention products above the
//                                           f32-exact bound)
//
// Operands: centered int8 codes x (M, K) row-major and w (K, N)
// row-major, optionally `batch` such pairs back to back. The products run
// on the tensor cores with mma.sync m16n8k32 (s8 x s8 -> s32), so the sum
// is exact in int32 while K < 2^17: |x w| <= 128 * 128 = 2^14, and
// K * 2^14 <= 2^31 - 1 (this repo's K is at most 17280). The epilogue
// is that of int8_matmul_pre, in its order, without contraction
// (__fmul_rn / __fsub_rn / __fadd_rn), so it matches the plain version in
// ops/int8_kernels.py bit for bit:
//   corr = f32(acc) - zp_wc[n] * xsum[m]
//   corr = corr - zp_xc * wsum[n]
//   corr = corr + (K * zp_xc) * zp_wc[n]
//   out  = (dx * delta_w[n]) * corr + bias[n]      (then bf16 if asked)
// with the scalars sc = [dx, zp_xc] read from device memory (no host sync).
//
// Blocking: a block computes a 128 x 64 tile with four warps of 64 x 32,
// stepping K by 64 through shared memory: x rows as they lie (16-byte
// loads when K is a multiple of 16), w transposed on the way in to
// [n][k] for the B fragments. Ragged M, N and K are zero-filled in shared
// memory; zero codes add nothing to the sums. No copy pipeline yet.
//
// What bounds it on this card: at the cin256 shapes (M = 4096 tokens,
// K = 384-1536, N = 384-3072) the GEMM does 1-10 GOP on 2-10 MB, so the
// int8 tensor-core rate bounds it (1979 TOP/s); the conv's im2col GEMM
// (M = 4 x 64 x 64, K = 9 x 192) likewise. A one-stage mma.sync loop
// without cp.async reaches a fraction of that; PERF.md has the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BKT = 64;          // K step through shared memory
constexpr int LD = BKT + 16;     // byte pitch 80: conflict-free fragments
constexpr int NTHREADS = 128;

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mode 0: int32 accumulator; 1: f32 epilogue; 2: bf16 epilogue
__global__ void __launch_bounds__(NTHREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ xsum,
                 const float* __restrict__ delta,
                 const float* __restrict__ zpc,
                 const float* __restrict__ wsum,
                 const float* __restrict__ bias,
                 const float* __restrict__ sc, void* __restrict__ out,
                 int M, int K, int N, int mode, int vec_x, int vec_w) {
  __shared__ __align__(16) int8_t As[BM][LD];
  __shared__ __align__(16) int8_t Bs[BN][LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m_base = blockIdx.x * BM;
  const int n_base = blockIdx.y * BN;
  const size_t z = blockIdx.z;
  x += z * (size_t)M * K;
  w += z * (size_t)K * N;

  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BKT) {
    __syncthreads();  // the previous step's fragments are consumed
    // A: 128 rows x 64 bytes = 512 chunks of 16 bytes, 4 per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx >> 2, c = (idx & 3) * 16;
      const int m = m_base + r, k = k0 + c;
      int8_t* dst = &As[r][c];
      if (vec_x && m < M && k + 16 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (m < M && k + e < K) ? x[(size_t)m * K + k + e]
                                        : (int8_t)0;
      }
    }
    // B: 64 k-rows x 64 n-columns, read along n (4 bytes), stored [n][k]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * NTHREADS;
      const int kr = idx >> 4, nc = (idx & 15) * 4;
      const int k = k0 + kr, n = n_base + nc;
      int8_t v[4];
      if (vec_w && k < K && n + 4 <= N) {
        const char4 q = *reinterpret_cast<const char4*>(w + (size_t)k * N + n);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (k < K && n + e < N) ? w[(size_t)k * N + n + e] : (int8_t)0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) Bs[nc + e][kr] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 4 * t4]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 4 * t4]);
        af[i][2] =
            *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + 4 * t4]);
        af[i][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + 4 * t4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 4 * t4]);
        bf[j][1] =
            *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 16 + 4 * t4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], af[i], bf[j]);
    }
  }

  float dx = 0.f, zp_xc = 0.f, kzx = 0.f;
  if (mode != 0) {
    dx = sc[0];
    zp_xc = sc[1];
    kzx = __fmul_rn((float)K, zp_xc);
  }
  const size_t obase = z * (size_t)M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float xs = mode != 0 ? xsum[z * (size_t)M + m] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_base + wn + j * 8 + 2 * t4 + e;
          if (n >= N) continue;
          const int a = acc[i][j][2 * h + e];
          const size_t o = obase + (size_t)m * N + n;
          if (mode == 0) {
            reinterpret_cast<int*>(out)[o] = a;
            continue;
          }
          const float zc = zpc[n];
          float corr = __fsub_rn((float)a, __fmul_rn(zc, xs));
          corr = __fsub_rn(corr, __fmul_rn(zp_xc, wsum[n]));
          corr = __fadd_rn(corr, __fmul_rn(kzx, zc));
          float v = __fmul_rn(__fmul_rn(dx, delta[n]), corr);
          if (bias) v = __fadd_rn(v, bias[n]);
          if (mode == 1)
            reinterpret_cast<float*>(out)[o] = v;
          else
            reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on the given stream (PyTorch's current stream) and returns
// cudaGetLastError() so that a refused launch is reported. mode 0 writes
// the int32 accumulators of `batch` products; modes 1 (f32) and 2 (bf16)
// apply the int8_matmul_pre epilogue (batch 1).
int tfmq_int8_gemm(const void* x, const void* w, const void* xsum,
                   const void* delta, const void* zp_c, const void* wsum,
                   const void* bias, const void* sc, void* out, int M, int K,
                   int N, int batch, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 0 || mode > 2 || batch < 1 || (mode != 0 && batch != 1))
    return (int)cudaErrorInvalidValue;
  const int vec_x = (K % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
  int8_gemm_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)xsum,
      (const float*)delta, (const float*)zp_c, (const float*)wsum,
      (const float*)bias, (const float*)sc, out, M, K, N, mode, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
