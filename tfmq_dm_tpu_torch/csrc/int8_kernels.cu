// Exact int8 GEMM for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes; see ops/int8_kernels.py).
//
// Counterparts of the Pallas kernels in tfmq_dm_tpu/ops/pallas_kernels.py:
//   tfmq_int8_gemm, f32 / bf16 epilogue  <- int8_matmul_pre
//                                           (_int8_mm_pre_kernel)
//   tfmq_int8_gemm, int32 accumulator    <- the int32 products that the
//                                           JAX package leaves to XLA
//                                           (int_ops.int8_conv2d's conv
//                                           on an im2col, and the
//                                           attention products above the
//                                           f32-exact bound)
//   tfmq_int8_gemm_fused                 <- int8_matmul_fused
//                                           (_int8_mm_kernel)
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
//
// The fused variant (int8_matmul_fused) takes f32 or bf16 x and
// quantizes each A tile in registers on its way to shared memory, as
// _int8_mm_kernel does in VMEM: code = clip(rint(x * (1/dx)) + zp_xc +
// 128, 0, 255) - 128, with 1/dx rounded once (IEEE division; the build
// has no --use_fast_math) and rintf, which rounds half to even as
// jnp.round does (roundf would not). Each thread sums the codes it
// quantizes into its rows' int32 sums over the real K (masked positions
// are code 0, not quantize(0)); four lanes share a row and add theirs
// with shuffles before the epilogue, which is int8_matmul_pre's. Like the
// TPU kernel, each N-tile re-quantizes its x rows (N / 64 times per row;
// the re-reads come from L2). Its bound at cin256's ff.net.0.proj (M 4096,
// 384 -> 3072, bf16 x and out) is bytes: 3.1 MB of x + 1.2 MB of w +
// 25 MB of output, about 8.8 us at 3.35 TB/s; the 9.7 G operations take
// about 4.9 us at the 1979 TOP/s int8 peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// One f32 x value -> its centered int8 code (the fused A-tile path).
__device__ __forceinline__ int quant_code(float v, float inv_dx, float zp) {
  float r = __fadd_rn(rintf(__fmul_rn(v, inv_dx)), zp);
  r = fminf(fmaxf(r, 0.f), 255.f);
  return (int)r - 128;
}

// 16 consecutive x values of row m from column k, zero past M and K.
__device__ __forceinline__ void load16(const float* x, int m, int k, int M,
                                       int K, int vec, float* v) {
  if (vec && m < M && k + 16 <= K) {
    const float4* p = reinterpret_cast<const float4*>(x + (size_t)m * K + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = p[j];
      v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = (m < M && k + e < K) ? x[(size_t)m * K + k + e] : 0.f;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* x, int m, int k,
                                       int M, int K, int vec, float* v) {
  if (vec && m < M && k + 16 <= K) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 u = p[j];
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {   // bf16 -> f32 is exact: a shift
        v[8 * j + 2 * h] = __uint_as_float(wd[h] << 16);
        v[8 * j + 2 * h + 1] = __uint_as_float(wd[h] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = (m < M && k + e < K) ? __bfloat162float(x[(size_t)m * K + k + e])
                                  : 0.f;
  }
}

// AT int8_t: x holds codes (modes 0-2); AT float / __nv_bfloat16: x is
// quantized on the way in and xsum summed in the kernel (modes 1-2).
// mode 0: int32 accumulator; 1: f32 epilogue; 2: bf16 epilogue
template <typename AT>
__global__ void __launch_bounds__(NTHREADS)
int8_gemm_kernel(const AT* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ xsum,
                 const float* __restrict__ delta,
                 const float* __restrict__ zpc,
                 const float* __restrict__ wsum,
                 const float* __restrict__ bias,
                 const float* __restrict__ sc, void* __restrict__ out,
                 int M, int K, int N, int mode, int vec_x, int vec_w) {
  __shared__ __align__(16) int8_t As[BM][LD];
  __shared__ __align__(16) int8_t Bs[BN][LD];
  constexpr bool kFused = !std::is_same<AT, int8_t>::value;
  __shared__ int xs_sh[kFused ? BM : 1];   // the fused rows' code sums

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

  float inv_dx = 0.f, zp_x = 0.f;   // fused: 1/dx, zp_xc + 128
  if constexpr (kFused) {
    inv_dx = 1.0f / sc[0];
    zp_x = __fadd_rn(sc[1], 128.f);
  }
  int rsum[4] = {0, 0, 0, 0};      // fused: code sums of rows r + 32 i

  for (int k0 = 0; k0 < K; k0 += BKT) {
    __syncthreads();  // the previous step's fragments are consumed
    // A: 128 rows x 64 bytes = 512 chunks of 16 bytes, 4 per thread; the
    // thread's chunk i lies in row (tid >> 2) + 32 i at every K step
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx >> 2, c = (idx & 3) * 16;
      const int m = m_base + r, k = k0 + c;
      int8_t* dst = &As[r][c];
      if constexpr (kFused) {
        float v[16];
        load16(x, m, k, M, K, vec_x, v);
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t p = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k + 4 * j + e;
            const int q =
                (m < M && kk < K) ? quant_code(v[4 * j + e], inv_dx, zp_x) : 0;
            rsum[i] += q;
            p |= (uint32_t)(q & 0xff) << (8 * e);
          }
          packed[j] = p;
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else if (vec_x && m < M && k + 16 <= K) {
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

  if constexpr (kFused) {
    // the four lanes of a row add their sums; one writes the row's total
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int t = rsum[i];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      if ((tid & 3) == 0) xs_sh[(tid >> 2) + 32 * i] = t;
    }
    __syncthreads();
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
      float xs = 0.f;
      if constexpr (kFused)
        xs = (float)xs_sh[m - m_base];
      else if (mode != 0)
        xs = xsum[z * (size_t)M + m];
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
  int8_gemm_kernel<int8_t><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)xsum,
      (const float*)delta, (const float*)zp_c, (const float*)wsum,
      (const float*)bias, (const float*)sc, out, M, K, N, mode, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// int8_matmul_fused: x (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1),
// quantized in the kernel with sc = [dx, zp_xc]; mode 1 (f32) or 2 (bf16)
// output.
int tfmq_int8_gemm_fused(const void* x, int x_bf16, const void* w,
                         const void* delta, const void* zp_c,
                         const void* wsum, const void* bias, const void* sc,
                         void* out, int M, int K, int N, int mode, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 1 || mode > 2) return (int)cudaErrorInvalidValue;
  const int vec_x = (K % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    int8_gemm_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)w, nullptr,
        (const float*)delta, (const float*)zp_c, (const float*)wsum,
        (const float*)bias, (const float*)sc, out, M, K, N, mode, vec_x,
        vec_w);
  else
    int8_gemm_kernel<float><<<grid, NTHREADS, 0, st>>>(
        (const float*)x, (const int8_t*)w, nullptr, (const float*)delta,
        (const float*)zp_c, (const float*)wsum, (const float*)bias,
        (const float*)sc, out, M, K, N, mode, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
