// Fused GroupNorm (+ scale-shift) + SiLU + per-tensor int8 activation
// quantization for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes; see ops/gn_kernels.py).
//
// Counterpart of gn_swish_quant_int8 in tfmq_dm_tpu/ops/pallas_kernels.py
// (_gn_sq_kernel, called through _gn_sq_call). NHWC x (B, HW, C), f32 or
// bf16, in; centered int8 codes (B, HW, C) out, the int8_conv2d input
// contract. The arithmetic is the Pallas kernel's, with its rounding
// points pinned one by one so that the plain version in ops/gn_kernels.py
// repeats them:
//   per-column f32 sums of x and x*x, folded into groups;
//   mean = gs1 * f32(1/n), var = max(gs2 * f32(1/n) - mean^2, 0),
//   n = HW * C / groups;
//   inv = rsqrt(var + eps) rounded once (__frsqrt_rn; rsqrtf is ~2 ulp);
//   a = inv * gamma, bb = beta - mean * a;
//   with the scale-shift pair (s, t): a * (1 + s), bb * (1 + s) + t;
//   y = x * a + bb, written __fadd_rn(__fmul_rn(.)) so that nvcc does not
//   contract it into an FMA;
//   SiLU y * (1 / (1 + expf(-y))) in f32 (expf, not __expf);
//   code = clip(rint(y * (1/delta)) + zp, nb, pb) - off (rintf rounds
//   half to even as jnp.round does; roundf would not).
//
// Three launches, deterministic (no atomics):
//   1. gn_stats:  threads run over channels, so each warp reads a row's
//      neighbouring channels (coalesced NHWC reads); a block sums a chunk
//      of ROWS rows into a (B, chunks, C) buffer of partials.
//   2. gn_affine: one block per (group, batch) sums the partials of each
//      channel over the chunks, then the channels of the group, in a fixed
//      order, and writes each channel's a and bb.
//   3. gn_apply:  reads x again and writes the codes, 16 per thread with
//      16-byte stores.
//
// CUDA C++ rather than Triton, although the work is a reduction and an
// elementwise pass: each rounding point above has to be pinned one by one
// (no contraction, correctly rounded rsqrt, rint, expf), and the port's
// other sources, their loader and their ptxas report are CUDA C++.
//
// What bounds it on this card: bytes. At SD's (8, 64, 64, 320) in bf16
// the function must read x once (21 MB) and write the codes once
// (10.5 MB): 31.5 MB, about 9.4 us at 3.35 TB/s. This kernel reads x
// twice (the TPU kernel keeps a batch row in VMEM between its two passes;
// a block here cannot hold one), so it moves at least 52 MB unless the
// second read hits the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STATS_THREADS = 128;
constexpr int AFFINE_THREADS = 128;
constexpr int APPLY_THREADS = 256;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }

__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// 16 consecutive values from p, 16-byte aligned.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = q[j];
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = q[j];
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {   // bf16 -> f32 is exact: a shift
      v[8 * j + 2 * h] = __uint_as_float(wd[h] << 16);
      v[8 * j + 2 * h + 1] = __uint_as_float(wd[h] & 0xffff0000u);
    }
  }
}

// grid (ceil(C / STATS_THREADS), chunks, B): the sums of x and x*x of one
// channel over rows [chunk * rows, (chunk + 1) * rows).
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
gn_stats(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
         int rows) {
  const int c = blockIdx.x * STATS_THREADS + threadIdx.x;
  if (c >= C) return;
  const int chunk = blockIdx.y, b = blockIdx.z, chunks = gridDim.y;
  const int r0 = chunk * rows, r1 = min(HW, r0 + rows);
  const T* xb = x + (size_t)b * HW * C + c;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const float v = ld(xb, (size_t)r * C);
    s1 = __fadd_rn(s1, v);
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  const size_t o = ((size_t)b * chunks + chunk) * C + c;
  part[o] = s1;
  part[(size_t)gridDim.z * chunks * C + o] = s2;
}

// grid (groups, B), dynamic shared memory 2 * (C / groups) floats: the
// group's statistics, then a (ab[0]) and bb (ab[1]) of its channels.
template <typename T>
__global__ void __launch_bounds__(AFFINE_THREADS)
gn_affine(const float* __restrict__ part, const float* __restrict__ gamma,
          const float* __restrict__ beta, const T* __restrict__ ss,
          float* __restrict__ ab, int C, int chunks, float inv_n,
          float eps) {
  extern __shared__ float col[];   // [2][cg]: per-column totals
  __shared__ float stat[2];        // mean, inv
  const int g = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int cg = C / gridDim.x;
  const size_t half = (size_t)B * chunks * C;
  for (int j = threadIdx.x; j < cg; j += AFFINE_THREADS) {
    const int c = g * cg + j;
    float s1 = 0.f, s2 = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const size_t o = ((size_t)b * chunks + ch) * C + c;
      s1 = __fadd_rn(s1, part[o]);
      s2 = __fadd_rn(s2, part[half + o]);
    }
    col[j] = s1;
    col[cg + j] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float g1 = 0.f, g2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      g1 = __fadd_rn(g1, col[j]);
      g2 = __fadd_rn(g2, col[cg + j]);
    }
    const float mean = __fmul_rn(g1, inv_n);
    const float var =
        fmaxf(__fsub_rn(__fmul_rn(g2, inv_n), __fmul_rn(mean, mean)), 0.f);
    stat[0] = mean;
    stat[1] = __frsqrt_rn(__fadd_rn(var, eps));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cg; j += AFFINE_THREADS) {
    const int c = g * cg + j;
    float a = __fmul_rn(stat[1], gamma[c]);
    float bb = __fsub_rn(beta[c], __fmul_rn(stat[0], a));
    if (ss != nullptr) {   // ss (B, 2, C): scale, shift
      const float s1p = __fadd_rn(1.f, ld(ss, (size_t)(2 * b) * C + c));
      a = __fmul_rn(a, s1p);
      bb = __fadd_rn(__fmul_rn(bb, s1p), ld(ss, (size_t)(2 * b + 1) * C + c));
    }
    ab[(size_t)b * C + c] = a;
    ab[(size_t)(B + b) * C + c] = bb;
  }
}

struct QuantArgs {
  float inv_d, zp, nb, pb, off;
  int swish;
};

__device__ __forceinline__ int gn_code(float v, float a, float bb,
                                       const QuantArgs& q) {
  float y = __fadd_rn(__fmul_rn(v, a), bb);
  if (q.swish) y = __fmul_rn(y, 1.0f / __fadd_rn(1.0f, expf(-y)));
  float r = __fadd_rn(rintf(__fmul_rn(y, q.inv_d)), q.zp);
  r = fminf(fmaxf(r, q.nb), q.pb);
  return (int)__fsub_rn(r, q.off);
}

// Grid-stride over the codes: 16 per thread (vec: HW * C a multiple of 16
// and x 16-byte aligned) or one.
template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
gn_apply(const T* __restrict__ x, const float* __restrict__ ab,
         const float* __restrict__ sc, int8_t* __restrict__ out, int B,
         int HW, int C, int nb, int pb, int off, int swish, int vec) {
  QuantArgs q;
  q.inv_d = 1.0f / sc[0];
  q.zp = sc[1];
  q.nb = (float)nb;
  q.pb = (float)pb;
  q.off = (float)off;
  q.swish = swish;
  const size_t per_b = (size_t)HW * C, total = per_b * B;
  const size_t stride = (size_t)gridDim.x * APPLY_THREADS;
  const size_t first = (size_t)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (vec) {
    for (size_t i = first; i < total / 16; i += stride) {
      const size_t e0 = i * 16;
      const int b = (int)(e0 / per_b);
      int c = (int)(e0 % C);
      const float* a = ab + (size_t)b * C;
      const float* bb = ab + (size_t)(B + b) * C;
      float v[16];
      load16(x + e0, v);
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int code = gn_code(v[e], a[c], bb[c], q);
        packed[e >> 2] |= (uint32_t)(code & 0xff) << (8 * (e & 3));
        if (++c == C) c = 0;
      }
      *reinterpret_cast<uint4*>(out + e0) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  } else {
    for (size_t e = first; e < total; e += stride) {
      const int b = (int)(e / per_b), c = (int)(e % C);
      out[e] = (int8_t)gn_code(ld(x, e), ab[(size_t)b * C + c],
                               ab[(size_t)(B + b) * C + c], q);
    }
  }
}

template <typename T>
int launch(const T* x, const float* gamma, const float* beta, const T* ss,
           const float* sc, float* part, float* ab, int8_t* out, int B, int HW,
           int C, int groups, int rows, float inv_n, float eps, int nb, int pb,
           int off, int swish, cudaStream_t st) {
  const int chunks = (HW + rows - 1) / rows;
  gn_stats<T><<<dim3((C + STATS_THREADS - 1) / STATS_THREADS, chunks, B),
                STATS_THREADS, 0, st>>>(x, part, HW, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)(C / groups) * sizeof(float);
  gn_affine<T><<<dim3(groups, B), AFFINE_THREADS, smem, st>>>(
      part, gamma, beta, ss, ab, C, chunks, inv_n, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * HW * C;
  const int vec = ((size_t)HW * C % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const size_t work = vec ? total / 16 : total;
  const size_t blocks = (work + APPLY_THREADS - 1) / APPLY_THREADS;
  gn_apply<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), APPLY_THREADS, 0,
                st>>>(x, ab, sc, out, B, HW, C, nb, pb, off, swish, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, HW, C) f32 (x_bf16 = 0) or bf16 (1); gamma, beta (C,) f32; ss
// (B, 2, C) of x's type or null; sc = [delta, zp] f32 on the device;
// scratch part (2, B, ceil(HW / rows), C) f32 and ab (2, B, C) f32;
// out (B, HW, C) int8. Launches on the given stream (PyTorch's current
// stream) and returns the first cudaGetLastError() that is not success.
int tfmq_gn_swish_quant(const void* x, int x_bf16, const void* gamma,
                        const void* beta, const void* ss, const void* sc,
                        void* part, void* ab, void* out, int B, int HW, int C,
                        int groups, int rows, float inv_n, float eps, int nb,
                        int pb, int off, int swish, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || HW < 1 || C < 1 || groups < 1 || C % groups != 0 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return launch<__nv_bfloat16>(
        (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
        (const __nv_bfloat16*)ss, (const float*)sc, (float*)part, (float*)ab,
        (int8_t*)out, B, HW, C, groups, rows, inv_n, eps, nb, pb, off, swish,
        st);
  return launch<float>((const float*)x, (const float*)gamma,
                       (const float*)beta, (const float*)ss, (const float*)sc,
                       (float*)part, (float*)ab, (int8_t*)out, B, HW, C, groups,
                       rows, inv_n, eps, nb, pb, off, swish, st);
}

}  // extern "C"
