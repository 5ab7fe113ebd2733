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
// tfmq_int8_gemm. Operands: centered int8 codes x (M, K) row-major and the
// weight codes K-major, w^T (N, ldb) row-major with ldb >= K (the deployed
// weight record keeps this copy, zero-padded to a multiple of 16; see
// ops/int_ops.IntWeight), optionally `batch` such pairs back to back. The
// products run on the tensor cores with mma.sync m16n8k32 (s8 x s8 ->
// s32), so the sum is exact in int32 while K < 2^17: |x w| <= 128 * 128 =
// 2^14, and K * 2^14 <= 2^31 - 1 (this repo's K is at most 17280). The
// epilogue is that of int8_matmul_pre, in its order, without contraction
// (__fmul_rn / __fsub_rn / __fadd_rn), so it matches the plain version in
// ops/int8_kernels.py bit for bit:
//   corr = f32(acc) - zp_wc[n] * xsum[m]
//   corr = corr - zp_xc * wsum[n]
//   corr = corr + (K * zp_xc) * zp_wc[n]
//   out  = (dx * delta_w[n]) * corr + bias[n]      (then bf16 if asked)
// with the scalars sc = [dx, zp_xc] read from device memory (no host sync).
//
// What bounds it on this card: at the cin256 shapes (M = 4096 tokens,
// K = 384-1536, N = 384-3072) a linear does 1-10 GOP on 2-30 MB, so the
// int8 tensor-core rate bounds it (1979 TOP/s), and the large convs'
// im2col GEMMs (M = 4 x 64 x 64, K = 9 x 192, N = 192: 28 MB of codes in,
// 13 MB of int32 out) are bound by their bytes. Design:
//   - both operands K-major, as the s8 tensor-core products take them
//     (wgmma takes 8-bit operands only K-major; ldmatrix, not transposed,
//     gives exactly the A and B fragments of mma.sync m16n8k32 from
//     [row][k] tiles, and ldmatrix.trans cannot transpose bytes), so no
//     byte is transposed in the kernel;
//   - a four-stage ring in dynamic shared memory filled by 16-byte
//     cp.async (zero-filled past M, N and K), one __syncthreads a step;
//   - two routes, chosen by ops/int8_kernels.gemm_plan from measured
//     times (PERF.md section 6): long K (>= 1600 bytes) takes wgmma, two
//     warpgroups of m64nBNk32 on 128 x 192 or 128 x 128 tiles read from
//     stages of 128 bytes of K in the 128-byte swizzle (chunk c of row r
//     at c ^ (r & 7)), loads two stages ahead and one stage's products in
//     flight; short K takes mma.sync m16n8k32 fed by ldmatrix on 128 x
//     128 or 64 x 128 tiles of eight warps, stages of 64 bytes swizzled as
//     c ^ ((r >> 1) & 3) so the 8 rows of an ldmatrix hit 8 bank groups.
//     The short-K shapes are dominated by their prologue and epilogue,
//     where the smaller mma.sync tiles keep more blocks on an SM;
//   - a grid that fills under half of the card splits K, each split
//     writing int32 partials to a workspace that a second kernel adds in
//     split order (exact in any order) before the epilogue;
//   - epilogue stores in pairs (int2, float2, bf16x2).
//
// tfmq_int8_gemm_fused (int8_matmul_fused) runs on the same machinery:
// the K-major weights (the deployed record's copy, or one the wrapper
// makes and counts), the four-stage cp.async ring, the 64-byte stages and
// mma.sync m16n8k32 fed by ldmatrix. It takes f32 or bf16 x and quantizes
// it on its way into shared memory, as _int8_mm_kernel does in VMEM:
// code = clip(rint(x * (1/dx)) + zp_xc + 128, 0, 255) - 128, with 1/dx
// rounded once (IEEE division; the build has no --use_fast_math) and
// rintf, which rounds half to even as jnp.round does (roundf would not);
// the codes' int32 row sums are taken over the real K (masked positions
// are code 0, not quantize(0)), and the epilogue is int8_matmul_pre's, so
// the result is bit-equal to quantize_act_int8 + int8_matmul_pre on every
// route (integer sums are exact; no error). A block owns a panel of 128
// or 64 rows of x and walks a group of 128-wide N tiles against it while
// the weight tiles stream through the ring; the groups are sized to fill
// the card. Two routes, chosen by ops/int8_kernels.fused_plan from a
// sweep on the card: where the panel fits beside the ring (K up to 3072
// at 64 rows) and pays (a group holds several N tiles, or the blocks run
// in one wave), the block quantizes it once into shared memory, so each
// row is quantized once a group instead of once an N tile; otherwise the
// panel streams through a ring of its own, each stage quantized as its
// step is loaded (x read into registers before a step's products, stored
// as codes after them), once an N tile, with small shared memory and two
// blocks an SM. At cin256's ff.net.0.proj (M 4096, 384 -> 3072, bf16 x
// and out) the bound is bytes: 3.1 MB of x + 1.2 MB of w + 25 MB of
// output, about 8.8 us at 3.35 TB/s; the 9.7 G operations take about
// 4.9 us at the 1979 TOP/s int8 peak. Times in PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

using tfmq::SmemAttr;
using tfmq::raise_smem;

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` < 16 zero-fills the rest (0: all)
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

// four 8 x 16-byte matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, lane (g, t4) receives bytes 4 t4 .. 4 t4 + 3 of row g
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------------------
// tfmq_int8_gemm: K-major codes, cp.async ring, ldmatrix + mma.sync s8
// ---------------------------------------------------------------------------

constexpr int KB = 64;              // bytes of K a pipeline stage
constexpr int GEMM_THREADS = 256;   // eight warps: 2 (M) x 4 (N)
constexpr int GEMM_STAGES = 4;

template <int BM, int BN>
struct GemmTile {
  static constexpr int WM = BM / 2, WN = BN / 4;   // a warp's tile
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int STAGE = (BM + BN) * KB;     // bytes
  static constexpr int SMEM = GEMM_STAGES * STAGE;
  static constexpr int CHUNKS = (BM + BN) * KB / 16;
  static_assert(NI % 2 == 0 && MI >= 1, "warp tile");
  static_assert(CHUNKS % GEMM_THREADS == 0 && (BM * KB / 16) %
                GEMM_THREADS == 0, "a stage's chunks split evenly");
};

// byte offset of 16-byte chunk c (0..3) of row r in a [rows][64] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * KB + ((c ^ ((r >> 1) & 3)) << 4);
}

// The epilogue's per-channel operands and the act grid's scalars.
struct Epi {
  const float* xsum;   // (M,) row sums of x's codes
  const float* delta;  // (N,)
  const float* zpc;    // (N,)
  const float* wsum;   // (N,)
  const float* bias;   // (N,) or null
  const float* sc;     // [dx, zp_xc]
};

// int8_matmul_pre's epilogue of one accumulator, in its order
__device__ __forceinline__ float epilogue(int a, float xs, int n,
                                          const Epi& e, float dx,
                                          float zp_xc, float kzx) {
  const float zc = e.zpc[n];
  float corr = __fsub_rn(__int2float_rn(a), __fmul_rn(zc, xs));
  corr = __fsub_rn(corr, __fmul_rn(zp_xc, e.wsum[n]));
  corr = __fadd_rn(corr, __fmul_rn(kzx, zc));
  float v = __fmul_rn(__fmul_rn(dx, e.delta[n]), corr);
  if (e.bias) v = __fadd_rn(v, e.bias[n]);
  return v;
}

// accumulators a0, a1 of a row whose code sum is xs, columns n, n + 1
// (n + 1 may be past N): int32 (mode 0) or the epilogue as f32 (1) /
// bf16 (2), paired stores where N is even (then n is even and the pair
// aligned)
__device__ __forceinline__ void store_pair_xs(void* out, size_t o, int n,
                                              int N, int a0, int a1,
                                              int mode, const Epi& e,
                                              float xs, float dx,
                                              float zp_xc, float kzx) {
  const bool both = n + 1 < N;
  const bool pair = both && (N & 1) == 0;
  if (mode == 0) {
    int* p = reinterpret_cast<int*>(out) + o;
    if (pair) {
      *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
    } else {
      p[0] = a0;
      if (both) p[1] = a1;
    }
    return;
  }
  const float v0 = epilogue(a0, xs, n, e, dx, zp_xc, kzx);
  const float v1 = both ? epilogue(a1, xs, n + 1, e, dx, zp_xc, kzx) : 0.f;
  if (mode == 1) {
    float* p = reinterpret_cast<float*>(out) + o;
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (both) p[1] = v1;
    }
  } else {
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(out) + o;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      p[0] = __float2bfloat16_rn(v0);
      if (both) p[1] = __float2bfloat16_rn(v1);
    }
  }
}

// the same for row m of the GEMM, its code sum read from e.xsum
__device__ __forceinline__ void store_pair(void* out, size_t o, int m,
                                           int n, int N, int a0, int a1,
                                           int mode, const Epi& e,
                                           float dx, float zp_xc,
                                           float kzx) {
  store_pair_xs(out, o, n, N, a0, a1, mode, e, mode ? e.xsum[m] : 0.f, dx,
                zp_xc, kzx);
}

// blockIdx.z: the batch index (batched, mode 0) or the K split (ws != 0:
// int32 partials of K range [z kchunk, (z + 1) kchunk) to ws[z]). mode 0:
// int32 out; 1: f32 epilogue; 2: bf16 epilogue.
template <int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                 Epi ep, void* __restrict__ out, int* __restrict__ ws,
                 int M, int N, int K, int ldb, int kchunk, int mode,
                 int batched, int vec_a, int vec_b) {
  using T = GemmTile<BM, BN>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t zb = batched ? blockIdx.z : 0;
  const int zs = batched ? 0 : blockIdx.z;
  a += zb * (size_t)M * K;
  bt += zb * (size_t)N * ldb;
  const int k_begin = zs * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int nk = (k_end - k_begin + KB - 1) / KB;
  const int wm = (warp >> 2) * T::WM, wn = (warp & 3) * T::WN;

  // one stage: BM rows of x and BN rows of w^T, 64 bytes of K each
  auto load_stage = [&](int st, int k0) {
    uint8_t* As = smem + st * T::STAGE;
    uint8_t* Bs = As + BM * KB;
#pragma unroll
    for (int i = 0; i < T::CHUNKS / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const bool is_a = idx < BM * KB / 16;
      const int r = (is_a ? idx : idx - BM * KB / 16) >> 2, c = idx & 3;
      const int k = k0 + 16 * c;
      const bool row_ok = is_a ? m0 + r < M : n0 + r < N;
      const int8_t* src = is_a ? a + (size_t)(m0 + r) * K + k
                               : bt + (size_t)(n0 + r) * ldb + k;
      uint8_t* dst = (is_a ? As : Bs) + swz(r, c);
      if (is_a ? vec_a : vec_b) {
        const bool in = row_ok && k < k_end;
        cp_async16(dst, in ? src : (is_a ? a : bt), in ? 16 : 0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t p = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k + 4 * q + e;
            const int v = (row_ok && kk < k_end) ? src[4 * q + e] : 0;
            p |= (uint32_t)(v & 0xff) << (8 * e);
          }
          w[q] = p;
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, k_begin + s * KB);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is consumed
    const int nxt = kt + GEMM_STAGES - 1;
    if (nxt < nk) load_stage(nxt % GEMM_STAGES, k_begin + nxt * KB);
    cp_async_commit();
    const uint8_t* As = smem + (kt % GEMM_STAGES) * T::STAGE;
    const uint8_t* Bs = As + BM * KB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {   // two k32 steps a stage
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], As + swz(wm + 16 * i + (lane & 15),
                                2 * kk + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, Bs + swz(wn + 8 * j + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8_16832(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  float dx = 0.f, zp_xc = 0.f, kzx = 0.f;
  int emode = mode;
  void* dst = out;
  size_t obase = zb * (size_t)M * N;
  if (ws) {   // a K split: int32 partials, the epilogue comes later
    emode = 0;
    dst = ws;
    obase = (size_t)zs * M * N;
  } else if (mode != 0) {
    dx = ep.sc[0];
    zp_xc = ep.sc[1];
    kzx = __fmul_rn((float)K, zp_xc);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t4;
        if (n >= N) continue;
        store_pair(dst, obase + (size_t)m * N + n, m, n, N,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1], emode, ep, dx,
                   zp_xc, kzx);
      }
    }
}

// Sum of the K splits' int32 partials, in split order, then the epilogue
// (or the int32 sum for mode 0); two columns a thread.
__global__ void int8_gemm_reduce(const int* __restrict__ ws, int split,
                                 Epi ep, void* __restrict__ out, int M,
                                 int N, int K, int mode) {
  float dx = 0.f, zp_xc = 0.f, kzx = 0.f;
  if (mode != 0) {
    dx = ep.sc[0];
    zp_xc = ep.sc[1];
    kzx = __fmul_rn((float)K, zp_xc);
  }
  const int np = (N + 1) >> 1;
  const long long total = (long long)M * np;
  const size_t mn = (size_t)M * N;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(idx / np), n = 2 * (int)(idx - (long long)m * np);
    const size_t o = (size_t)m * N + n;
    int s0 = 0, s1 = 0;
    for (int z = 0; z < split; ++z) {
      s0 += ws[z * mn + o];
      if (n + 1 < N) s1 += ws[z * mn + o + 1];
    }
    store_pair(out, o, m, n, N, s0, s1, mode, ep, dx, zp_xc, kzx);
  }
}

// ---------------------------------------------------------------------------
// x quantized on its way into shared memory (int8_matmul_fused)
// ---------------------------------------------------------------------------

// One f32 x value -> its centered int8 code.
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

// x values v of row m, columns k .. k + 15 -> their centered codes packed
// in four words (code 0 past M and K, not quantize(0)); adds the codes to
// sum
__device__ __forceinline__ uint4 codes16(const float* v, int m, int k,
                                         int M, int K, float inv_dx,
                                         float zp, int& sum) {
  uint32_t p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = (m < M && k + 4 * j + e < K)
                        ? quant_code(v[4 * j + e], inv_dx, zp) : 0;
      sum += q;
      w |= (uint32_t)(q & 0xff) << (8 * e);
    }
    p[j] = w;
  }
  return make_uint4(p[0], p[1], p[2], p[3]);
}

// ---------------------------------------------------------------------------
// the wgmma route: the same stages, 128 bytes of K each in wgmma's 128-byte
// swizzle, one warpgroup per 64 rows running m64nBNk32 from shared memory
// ---------------------------------------------------------------------------

constexpr int WKB = 128;   // bytes of K a stage: one swizzle row

constexpr int WG = 2;      // consumer warpgroups, 64 rows each

template <int BN>
struct WgTile {
  static constexpr int BM = 64 * WG, THREADS = 128 * WG;
  static constexpr int A_BYTES = BM * WKB, B_BYTES = BN * WKB;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = GEMM_STAGES * STAGE + 1024;   // + alignment
  static constexpr int CHUNKS = (BM + BN) * WKB / 16;
  static_assert(CHUNKS % THREADS == 0 && (BM * WKB / 16) % THREADS == 0,
                "a stage's chunks split evenly");
};

// byte offset of 16-byte chunk c (0..7) of row r in a [rows][128] tile:
// chunk c of row r at c ^ (r & 7), the layout wgmma's B128 mode reads
__device__ __forceinline__ int swz128(int r, int c) {
  return r * WKB + ((c ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, groups of 8
// rows 1024 bytes apart (the tile's base is 1024-byte aligned; a k32 step
// within the row advances the start address by 32 bytes)
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n192(int* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_s8_n128(d, da, db);
  else
    wgmma_s8_n192(d, da, db);
}

// as int8_gemm_kernel, on wgmma: WG warpgroups of 64 rows x BN columns
template <int BN>
__global__ void __launch_bounds__(128 * WG, 1)
int8_wgmma_kernel(const int8_t* __restrict__ a,
                  const int8_t* __restrict__ bt, Epi ep,
                  void* __restrict__ out, int* __restrict__ ws, int M, int N,
                  int K, int ldb, int kchunk, int mode, int batched,
                  int vec_a, int vec_b) {
  using T = WgTile<BN>;
  constexpr int BM = T::BM, NR = BN / 2;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wl = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t zb = batched ? blockIdx.z : 0;
  const int zs = batched ? 0 : blockIdx.z;
  a += zb * (size_t)M * K;
  bt += zb * (size_t)N * ldb;
  const int k_begin = zs * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int nk = (k_end - k_begin + WKB - 1) / WKB;

  auto load_stage = [&](int st, int k0) {
    uint8_t* As = smem + st * T::STAGE;
    uint8_t* Bs = As + T::A_BYTES;
#pragma unroll
    for (int i = 0; i < T::CHUNKS / T::THREADS; ++i) {
      const int idx = tid + i * T::THREADS;
      const bool is_a = idx < BM * WKB / 16;
      const int r = (is_a ? idx : idx - BM * WKB / 16) >> 3, c = idx & 7;
      const int k = k0 + 16 * c;
      const bool row_ok = is_a ? m0 + r < M : n0 + r < N;
      const int8_t* src = is_a ? a + (size_t)(m0 + r) * K + k
                               : bt + (size_t)(n0 + r) * ldb + k;
      uint8_t* dst = (is_a ? As : Bs) + swz128(r, c);
      if (is_a ? vec_a : vec_b) {
        const bool in = row_ok && k < k_end;
        cp_async16(dst, in ? src : (is_a ? a : bt), in ? 16 : 0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t p = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k + 4 * q + e;
            const int v = (row_ok && kk < k_end) ? src[4 * q + e] : 0;
            p |= (uint32_t)(v & 0xff) << (8 * e);
          }
          w[q] = p;
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  int acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0;

  // loads run two stages ahead of the products, and one stage's products
  // stay in flight while the next stage's are issued: at step kt the
  // barrier finds every warpgroup past its wait for step kt - 2's
  // products, so stage (kt + 2) % 4, which they read, is reloaded after it
  static_assert(GEMM_STAGES == 4, "two stages ahead, one in flight");
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < nk) load_stage(s, k_begin + s * WKB);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<1>();
    // this thread's copies, seen by the async proxy that wgmma reads with
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage kt landed; step kt - 2's products are done
    if (kt + 2 < nk)
      load_stage((kt + 2) % GEMM_STAGES, k_begin + (kt + 2) * WKB);
    cp_async_commit();
    const uint8_t* As = smem + (kt % GEMM_STAGES) * T::STAGE + wg * 64 * WKB;
    const uint8_t* Bs = smem + (kt % GEMM_STAGES) * T::STAGE + T::A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WKB / 32; ++kk)
      wgmma_s8<BN>(acc, wg_desc(As + 32 * kk), wg_desc(Bs + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();

  float dx = 0.f, zp_xc = 0.f, kzx = 0.f;
  int emode = mode;
  void* dst = out;
  size_t obase = zb * (size_t)M * N;
  if (ws) {   // a K split: int32 partials, the epilogue comes later
    emode = 0;
    dst = ws;
    obase = (size_t)zs * M * N;
  } else if (mode != 0) {
    dx = ep.sc[0];
    zp_xc = ep.sc[1];
    kzx = __fmul_rn((float)K, zp_xc);
  }
  // accumulator 4 j + 2 h + e: row 16 wl + g + 8 h, column 8 j + 2 t4 + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * wl + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      if (n >= N) continue;
      store_pair(dst, obase + (size_t)m * N + n, m, n, N, acc[4 * j + 2 * h],
                 acc[4 * j + 2 * h + 1], emode, ep, dx, zp_xc, kzx);
    }
  }
}

template <int BN>
int launch_wgmma(const int8_t* x, const int8_t* wt, const Epi& ep, void* out,
                 int* ws, int M, int N, int K, int ldb, int batch, int split,
                 int kchunk, int mode, int vec_a, int vec_b,
                 cudaStream_t stream) {
  using T = WgTile<BN>;
  static SmemAttr attr;
  int err = raise_smem(int8_wgmma_kernel<BN>, attr, T::SMEM);
  if (err) return err;
  dim3 grid((M + T::BM - 1) / T::BM, (N + BN - 1) / BN,
            batch > 1 ? batch : split);
  int8_wgmma_kernel<BN><<<grid, T::THREADS, T::SMEM, stream>>>(
      x, wt, ep, out, split > 1 ? ws : nullptr, M, N, K, ldb, kchunk, mode,
      batch > 1, vec_a, vec_b);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_gemm(const int8_t* x, const int8_t* wt, const Epi& ep, void* out,
                int* ws, int M, int N, int K, int ldb, int batch, int split,
                int kchunk, int mode, int vec_a, int vec_b,
                cudaStream_t stream) {
  using T = GemmTile<BM, BN>;
  static SmemAttr attr;
  int err = raise_smem(int8_gemm_kernel<BM, BN>, attr, T::SMEM);
  if (err) return err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch > 1 ? batch : split);
  int8_gemm_kernel<BM, BN><<<grid, GEMM_THREADS, T::SMEM, stream>>>(
      x, wt, ep, out, split > 1 ? ws : nullptr, M, N, K, ldb, kchunk, mode,
      batch > 1, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8_matmul_fused on mma.sync: a block takes a BM-row panel of x and a
// group of 128-wide N tiles, the weight tiles streaming through the
// four-stage ring. STREAM false: the block quantizes its whole panel once
// into shared memory ([K / 64][BM][64] codes in the GEMM's stage layout)
// and walks its N tiles against it. STREAM true, for a K whose panel does
// not fit beside the ring: the panel's stages take a four-stage ring of
// their own, each step's x read into registers before the step's products
// and quantized into its stage after them, once for each N tile.
// ---------------------------------------------------------------------------

constexpr int FP_BN = 128;   // N tile of the panel kernel

template <int BM>
struct PanelTile {
  static constexpr int RING = GEMM_STAGES * FP_BN * KB;
  static constexpr int A_IT = BM * KB / 16 / GEMM_THREADS;  // x chunks a
                                                            // thread, a step
  // na stages of the panel, the weights' ring, the row sums
  static int smem(int na) { return na * BM * KB + RING + BM * 4; }
};

template <typename AT, int BM, bool STREAM>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
int8_fused_panel_kernel(const AT* __restrict__ x,
                        const int8_t* __restrict__ bt, Epi ep,
                        void* __restrict__ out, int M, int N, int K,
                        int ldb, int tpg, int mode, int vec_x, int vec_b) {
  using T = GemmTile<BM, FP_BN>;
  constexpr int MI = T::MI, NI = T::NI, A_IT = PanelTile<BM>::A_IT;
  extern __shared__ __align__(128) uint8_t smem[];
  const int nk = (K + KB - 1) / KB;
  uint8_t* panel = smem;
  uint8_t* ring = smem + (size_t)(STREAM ? GEMM_STAGES : nk) * BM * KB;
  int* xs = reinterpret_cast<int*>(ring + PanelTile<BM>::RING);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int t_begin = blockIdx.y * tpg;
  const int t_end = min((N + FP_BN - 1) / FP_BN, t_begin + tpg);
  const int total = (t_end - t_begin) * nk;   // (N tile, K stage) steps
  const int wm = (warp >> 2) * T::WM, wn = (warp & 3) * T::WN;
  const float inv_dx = 1.0f / ep.sc[0];
  const float zp_x = __fadd_rn(ep.sc[1], 128.f);

  // step it -> ring stage st: w^T rows of its N tile, its 64 bytes of K
  auto load_b = [&](int st, int it) {
    const int n0 = (t_begin + it / nk) * FP_BN, k0 = (it % nk) * KB;
    uint8_t* Bs = ring + st * FP_BN * KB;
#pragma unroll
    for (int i = 0; i < FP_BN * KB / 16 / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 2, c = idx & 3, k = k0 + 16 * c;
      const bool row_ok = n0 + r < N;
      const int8_t* src = bt + (size_t)(n0 + r) * ldb + k;
      uint8_t* dst = Bs + swz(r, c);
      if (vec_b) {
        const bool in = row_ok && k < K;
        cp_async16(dst, in ? src : bt, in ? 16 : 0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t p = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = (row_ok && k + 4 * q + e < K) ? src[4 * q + e] : 0;
            p |= (uint32_t)(v & 0xff) << (8 * e);
          }
          w[q] = p;
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  // STREAM: this thread's x chunks of step it are chunk idx & 3 of row
  // idx >> 2, idx = tid + GEMM_THREADS i; fetch_a reads them, store_a
  // writes their codes to panel stage st and, in the group's first N
  // tile, adds them to the row sums
  float xv[A_IT][16];
  auto fetch_a = [&](int it) {
    const int k0 = (it % nk) * KB;
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      load16(x, m0 + (idx >> 2), k0 + 16 * (idx & 3), M, K, vec_x, xv[i]);
    }
  };
  auto store_a = [&](int st, int it) {
    const int k0 = (it % nk) * KB;
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int idx = tid + i * GEMM_THREADS, r = idx >> 2, c = idx & 3;
      int sum = 0;
      *reinterpret_cast<uint4*>(panel + (size_t)st * BM * KB + swz(r, c)) =
          codes16(xv[i], m0 + r, k0 + 16 * c, M, K, inv_dx, zp_x, sum);
      if (it < nk && sum) atomicAdd(&xs[r], sum);
    }
  };

  for (int i = tid; i < BM; i += GEMM_THREADS) xs[i] = 0;
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {   // the weights' first steps
    if (s < total) load_b(s, s);
    cp_async_commit();
  }
  __syncthreads();   // the row sums are zero
  if constexpr (STREAM) {
#pragma unroll
    for (int s = 0; s < GEMM_STAGES - 1; ++s)
      if (s < total) {
        fetch_a(s);
        store_a(s, s);
      }
  } else {
    // the panel: chunk c (16 codes) of row r, its codes' sum added to xs[r]
    const int cpr = nk * (KB / 16);
    for (int idx = tid; idx < BM * cpr; idx += GEMM_THREADS) {
      const int r = idx / cpr, c = idx - r * cpr;
      float v[16];
      int sum = 0;
      load16(x, m0 + r, 16 * c, M, K, vec_x, v);
      *reinterpret_cast<uint4*>(panel + (size_t)(c >> 2) * BM * KB +
                                swz(r, c & 3)) =
          codes16(v, m0 + r, 16 * c, M, K, inv_dx, zp_x, sum);
      if (sum) atomicAdd(&xs[r], sum);
    }
  }

  const float dx = ep.sc[0], zp_xc = ep.sc[1];
  const float kzx = __fmul_rn((float)K, zp_xc);
  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<GEMM_STAGES - 2>();
    // step it's weights (and, STREAM, its x codes) landed; step it - 1's
    // are consumed; the row sums are complete by the first tile's last
    // step; without STREAM, at it = 0 the whole panel is
    __syncthreads();
    const int nxt = it + GEMM_STAGES - 1;
    if (nxt < total) load_b(nxt % GEMM_STAGES, nxt);
    cp_async_commit();
    if (STREAM && nxt < total) fetch_a(nxt);
    const int kt = it % nk;
    const uint8_t* As =
        panel + (size_t)(STREAM ? it % GEMM_STAGES : kt) * BM * KB;
    const uint8_t* Bs = ring + (it % GEMM_STAGES) * FP_BN * KB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {   // two k32 steps a stage
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], As + swz(wm + 16 * i + (lane & 15),
                                2 * kk + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, Bs + swz(wn + 8 * j + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8_16832(acc[i][j], af[i], bf[j]);
    }
    // stage nxt % GEMM_STAGES was step it - 1's, which every thread is past
    if (STREAM && nxt < total) store_a(nxt % GEMM_STAGES, nxt);
    if (kt != nk - 1) continue;
    // the N tile is done: the epilogue, then the next tile from zero
    const int n0 = (t_begin + it / nk) * FP_BN;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
        const float xsum = (float)xs[m - m0];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int n = n0 + wn + 8 * j + 2 * t4;
          if (n >= N) continue;
          store_pair_xs(out, (size_t)m * N + n, n, N, acc[i][j][2 * h],
                        acc[i][j][2 * h + 1], mode, ep, xsum, dx, zp_xc,
                        kzx);
        }
      }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }
  cp_async_wait<0>();
}

template <typename AT, int BM, bool STREAM>
int launch_panel(const AT* x, const int8_t* wt, const Epi& ep, void* out,
                 int M, int N, int K, int ldb, int groups, int mode,
                 int vec_x, int vec_b, cudaStream_t stream) {
  static SmemAttr attr;
  const int smem =
      PanelTile<BM>::smem(STREAM ? GEMM_STAGES : (K + KB - 1) / KB);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int err = raise_smem(int8_fused_panel_kernel<AT, BM, STREAM>, attr, smem);
  if (err) return err;
  const int ntiles = (N + FP_BN - 1) / FP_BN;
  const int tpg = (ntiles + groups - 1) / groups;
  dim3 grid((M + BM - 1) / BM, (ntiles + tpg - 1) / tpg);
  int8_fused_panel_kernel<AT, BM, STREAM>
      <<<grid, GEMM_THREADS, smem, stream>>>(x, wt, ep, out, M, N, K, ldb,
                                             tpg, mode, vec_x, vec_b);
  return (int)cudaGetLastError();
}

template <typename AT>
int launch_fused(const AT* x, const int8_t* wt, const Epi& ep, void* out,
                 int M, int N, int K, int ldb, int stream_a, int bm,
                 int groups, int mode, int vec_x, int vec_b,
                 cudaStream_t s) {
  if (bm == 128)
    return stream_a ? launch_panel<AT, 128, true>(x, wt, ep, out, M, N, K,
                                                  ldb, groups, mode, vec_x,
                                                  vec_b, s)
                    : launch_panel<AT, 128, false>(x, wt, ep, out, M, N, K,
                                                   ldb, groups, mode, vec_x,
                                                   vec_b, s);
  return stream_a ? launch_panel<AT, 64, true>(x, wt, ep, out, M, N, K, ldb,
                                               groups, mode, vec_x, vec_b, s)
                  : launch_panel<AT, 64, false>(x, wt, ep, out, M, N, K, ldb,
                                                groups, mode, vec_x, vec_b,
                                                s);
}
}  // namespace

extern "C" {

// Launches on the given stream (PyTorch's current stream) and returns
// cudaGetLastError() so that a refused launch is reported. x (batch, M, K)
// codes; wt (batch, N, ldb) the weight codes K-major, ldb >= K, zero past
// K. mode 0 writes the int32 accumulators of `batch` products; modes 1
// (f32) and 2 (bf16) apply the int8_matmul_pre epilogue (batch 1). The
// route (wgmma 1, mma.sync 0), the tile (bm x bn) and the K split come
// from the caller's plan (ops/int8_kernels.gemm_plan): `split` ranges of
// `kchunk` bytes of K (a multiple of 128), their partials in ws (split,
// M, N) int32, added by a second kernel.
int tfmq_int8_gemm(const void* x, const void* wt, const void* xsum,
                   const void* delta, const void* zp_c, const void* wsum,
                   const void* bias, const void* sc, void* out, void* ws,
                   int M, int K, int N, int ldb, int batch, int mode, int bm,
                   int bn, int split, int kchunk, int wgmma, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 0 || mode > 2 || batch < 1 || (mode != 0 && batch != 1) ||
      M <= 0 || N <= 0 || K <= 0 || ldb < K || split < 1 ||
      kchunk <= 0 || kchunk % WKB || (split > 1 && (batch != 1 || !ws)) ||
      (long long)kchunk * (split - 1) >= K ||
      (long long)kchunk * split < K || batch > 65535 || split > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec_a = (K % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_b = (ldb % 16 == 0) && ((uintptr_t)wt % 16 == 0);
  const Epi ep = {(const float*)xsum, (const float*)delta,
                  (const float*)zp_c, (const float*)wsum,
                  (const float*)bias, (const float*)sc};
  const int8_t *xi = (const int8_t*)x, *wi = (const int8_t*)wt;
  int* wsi = (int*)ws;
  cudaStream_t s = (cudaStream_t)stream;
#define TFMQ_GEMM(BM, BN)                                                    \
  launch_gemm<BM, BN>(xi, wi, ep, out, wsi, M, N, K, ldb, batch, split,     \
                      kchunk, mode, vec_a, vec_b, s)
#define TFMQ_WGMMA(BN)                                                       \
  launch_wgmma<BN>(xi, wi, ep, out, wsi, M, N, K, ldb, batch, split, kchunk, \
                   mode, vec_a, vec_b, s)
  int rc;
  if (wgmma && bm == 128 && bn == 192) rc = TFMQ_WGMMA(192);
  else if (wgmma && bm == 128 && bn == 128) rc = TFMQ_WGMMA(128);
  else if (!wgmma && bm == 128 && bn == 128) rc = TFMQ_GEMM(128, 128);
  else if (!wgmma && bm == 64 && bn == 128) rc = TFMQ_GEMM(64, 128);
  else return (int)cudaErrorInvalidValue;
#undef TFMQ_WGMMA
#undef TFMQ_GEMM
  if (rc || split == 1) return rc;
  const long long pairs = (long long)M * ((N + 1) / 2);
  const int blocks = (int)((pairs + 255) / 256 < 2048 ? (pairs + 255) / 256
                                                      : 2048);
  int8_gemm_reduce<<<blocks, 256, 0, s>>>(wsi, split, ep, out, M, N, K,
                                          mode);
  return (int)cudaGetLastError();
}

// int8_matmul_fused: x (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1),
// quantized in the kernel with sc = [dx, zp_xc]; wt (N, ldb) the weight
// codes K-major as for tfmq_int8_gemm; mode 1 (f32) or 2 (bf16) output.
// The plan from the caller (ops/int8_kernels.fused_plan): panels of bm
// (128 or 64) rows, N tiles of bn = 128 cut into `groups` groups, x
// quantized once a panel (stream 0; the panel must fit beside the ring)
// or stage by stage (stream 1).
int tfmq_int8_gemm_fused(const void* x, int x_bf16, const void* wt,
                         const void* delta, const void* zp_c,
                         const void* wsum, const void* bias, const void* sc,
                         void* out, int M, int K, int N, int ldb, int mode,
                         int stream_a, int bm, int bn, int groups,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 1 || mode > 2 || M <= 0 || N <= 0 || K <= 0 || ldb < K ||
      ldb % 16 || groups < 1 || groups > 65535 || (bm != 128 && bm != 64) ||
      bn != FP_BN)
    return (int)cudaErrorInvalidValue;
  const int vec_x = (K % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_b = (uintptr_t)wt % 16 == 0;
  const Epi ep = {nullptr, (const float*)delta, (const float*)zp_c,
                  (const float*)wsum, (const float*)bias, (const float*)sc};
  const int8_t* wi = (const int8_t*)wt;
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? launch_fused((const __nv_bfloat16*)x, wi, ep, out, M, N,
                               K, ldb, stream_a, bm, groups, mode, vec_x,
                               vec_b, s)
                : launch_fused((const float*)x, wi, ep, out, M, N, K, ldb,
                               stream_a, bm, groups, mode, vec_x, vec_b, s);
}

}  // extern "C"
