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
// accumulator fragments).
//
// The conv (implicit GEMM: M = B*Ho*Wo pixels, N = Cout, K = KH*KW*Cin,
// walked one tap and one chunk of channels a step) is bound by its bf16
// products at every geometry of the two int4-serving paths (cin256's
// 64x64 3x3 192 -> 192 at batch 4: 10.9 GFLOP, 11 us at the dense peak,
// against 3.4 us for its bytes). It carries the linear's machinery over:
// the per-block dequant table (the conv's rule above) and a cp.async
// ring that holds each step's A tile, gathered as 16-byte chunks (8 bf16
// channels of one pixel at one tap; the halo, Cin and M zero-filled by
// the copy's source size; Cin % 8 != 0 takes element loads instead), and
// its packed weight bytes, under one barrier a step. Two routes, chosen
// by ops/int4_kernels.conv_plan from a cost model fitted to a sweep of
// every tile and split at every path geometry (PERF.md section 6):
//   - mma.sync m16n8k16 on 128 x 128 or 128 x 64 tiles of 8 warps, steps
//     of 32 channels, a four-stage ring; A fragments by ldmatrix straight
//     from the ring (64-byte rows, chunk c of row r at c ^ ((r >> 1) &
//     3)), B by ldmatrix.trans from a double-buffered bf16 [k][n] tile
//     the table lookups fill; two blocks an SM. It is bound by shared
//     memory: the fragments' ldmatrix traffic and the lookups;
//   - wgmma m64n192k16 (bf16, f32 accumulators) where Cin comes in whole
//     64-channel steps: a pre-pass dequantizes the weights once a call
//     into a bf16 K-major (N, K) buffer (same table, same rule), then two
//     warpgroups of 64 pixels run a 128 x 192 tile with both operands in
//     shared memory in the 128-byte swizzle (steps of 64 channels), a
//     five-stage cp.async ring loaded three steps ahead; one block an SM.
//     Dequantizing in the conv instead (each block's lookups into a
//     K-major tile, between the barrier and the products) measured 1.5x
//     slower at cin256's 64x64 192 -> 192, and 2x without the products
//     removed: the lookups, not the tensor cores, held the step.
// Where the output tiles fill under half of the blocks the card holds, K
// splits over whole steps (taps x channel chunks), partial sums added in
// split order by int4_linear_reduce, so two calls are bit-identical. Both
// routes round where the TPU kernel does and differ from the plain
// version only in the order of the f32 sums (tensor cores: within 2e-5
// of the largest output up to K 4608, in proportion to K beyond).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
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

// The accumulators of a warp tile (rows m0 + i*16 + g (+8), columns n0 +
// j*8 + 2*t4 (+1)), acc(i, j, e) being the e-th (0..3) of row block i and
// column block j, as mma.sync lays them out: with one split, + bias, to
// out; with several (grid z), the partial sums to ws[z] (M, N). Pairs of
// columns go out as float2, so every 32-byte sector is written whole.
template <int MI, int NJ, typename Acc>
__device__ __forceinline__ void store_tile(Acc acc, float* __restrict__ out,
                                           float* __restrict__ ws,
                                           const float* __restrict__ bias,
                                           int M, int N, int m0, int n0,
                                           int g, int t4) {
  const bool split = gridDim.z > 1;
  float* dst = split ? ws + (size_t)blockIdx.z * M * N : out;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      float* row = dst + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + j * 8 + 2 * t4;
        float v0 = acc(i, j, 2 * h), v1 = acc(i, j, 2 * h + 1);
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

  store_tile<T::MI, T::NJ>(
      [&](int i, int j, int e) { return acc[i][j][e]; }, out, ws, bias, M, N,
      m_base + wm, n_base + wn, g, t4);
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
// pixels, N = Cout and K = KH*KW*Cin, walked in steps of one tap and
// CV_BK input channels (step s: tap s / csteps, channels
// (s % csteps) * CV_BK ..); blockIdx.z takes the steps [z * spc,
// (z + 1) * spc). One split: bias added, out written; several: the
// partial sums go to ws[z] (M, N) and int4_linear_reduce adds them.
// Each step's A tile (bf16 [BM][CV_BK], 16-byte chunks of 8 channels of
// one pixel at one tap, zero past the image, Cin and M) and its packed
// weight bytes ([CV_BK][BN / 2]) arrive by cp.async in a CV_STAGES ring.
// The A fragments come by ldmatrix straight from the ring (rows of 64
// bytes, chunk c of row r at c ^ ((r >> 1) & 3), so the 8 rows of an
// ldmatrix phase hit 8 bank groups); the bytes are dequantized by table
// lookup into a double-buffered bf16 [k][n] tile (ldmatrix.trans).
// ---------------------------------------------------------------------------

constexpr int CV_BK = 32;
constexpr int CV_STAGES = 4;

template <int BM, int BN, int WM, int WN>
struct ConvTile {
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  static constexpr int MI = TM / 16, NJ = TN / 8;
  static constexpr int BP = BN + 8;                  // bf16 pitch of Bs
  static constexpr int ACH = BM * CV_BK / 8;         // 16-byte chunks of A
  static constexpr int A_IT = ACH / THREADS;
  static constexpr int WCH = CV_BK * BN / 32;        // 16-byte chunks of w
  static constexpr int B_RSTEP = THREADS / (BN / 2);
  static constexpr int B_ROWS = CV_BK / B_RSTEP;
  static constexpr int A_BYTES = BM * CV_BK * 2;
  static constexpr int W_BYTES = CV_BK * BN / 2;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int B_OFF = CV_STAGES * STAGE;
  static constexpr int T_OFF = B_OFF + 2 * CV_BK * BP * 2;
  static constexpr int SMEM = T_OFF + 16 * BN * 2;
  static_assert(MI >= 1 && NJ % 2 == 0, "warp tile");
  static_assert(A_IT >= 1 && A_IT * THREADS == ACH, "A loader");
  static_assert(B_RSTEP >= 1 && B_ROWS * B_RSTEP == CV_BK, "B loader");
  static_assert(STAGE % 16 == 0 && B_OFF % 16 == 0 && T_OFF % 16 == 0,
                "alignment");
};

// byte offset of 16-byte chunk c (0..3) of row r in a [rows][64-byte] tile
__device__ __forceinline__ int cv_swz(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
int4_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ wp,
                 const float* __restrict__ delta,
                 const float* __restrict__ zpc,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ ws, int B, int H, int W, int Cin,
                 int N, int KW, int PH, int PW, int Ho, int Wo, int nsteps_all,
                 int spc, int vec_a, int vec_b) {
  using T = ConvTile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  typedef __nv_bfloat16 BTile[T::BP];
  BTile* Bs = reinterpret_cast<BTile*>(smem + T::B_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = B * Ho * Wo;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const int s_begin = blockIdx.z * spc;
  const int nsteps = min(nsteps_all, s_begin + spc) - s_begin;
  const int csteps = (Cin + CV_BK - 1) / CV_BK;
  const int nbytes = (N + 1) >> 1;
  const int wm = (warp / WN) * T::TM, wn = (warp % WN) * T::TN;

  // the dequant table: lut[v][n] = bf16(f32((q - zp) * delta)) of channel
  // n_base + n for the code q = (v ^ 8) - 8 of nibble v (0 past N)
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem + T::T_OFF);
  for (int i = tid; i < 16 * BN; i += T::THREADS) {
    const int v = i / BN, n = n_base + i % BN;
    float w = 0.f;
    if (n < N) w = ((float)((v ^ 8) - 8) - zpc[n]) * delta[n];
    lut[i] = __bfloat16_as_ushort(__float2bfloat16_rn(w));
  }
  // this thread's A chunks: row (tid + i * THREADS) >> 2 of the tile, one
  // pixel for every step, channels 8 * (tid & 3) .. + 7 of the step's
  const int a_q = (tid & 3) * 8;
  int a_oh[T::A_IT], a_ow[T::A_IT];
  size_t a_pix[T::A_IT];
#pragma unroll
  for (int i = 0; i < T::A_IT; ++i) {
    const int m = m_base + ((tid + i * T::THREADS) >> 2);
    const int mm = m < M ? m : 0;
    const int b = mm / (Ho * Wo), rem = mm - b * Ho * Wo;
    a_oh[i] = m < M ? rem / Wo : -(1 << 20);   // rows past M: never inside
    a_ow[i] = rem - (rem / Wo) * Wo;
    a_pix[i] = (((size_t)b * H + rem / Wo) * W + a_ow[i]) * Cin;
  }
  // this thread's byte column of the B tile (channels 2 jbl, 2 jbl + 1)
  const int jbl = tid % (BN / 2), b_r0 = tid / (BN / 2);

  // step s -> ring stage st: the A tile and the packed bytes
  auto issue = [&](int st, int s) {
    unsigned char* as = smem + st * T::STAGE;
    uint8_t* wsb = smem + st * T::STAGE + T::A_BYTES;
    const int tap = s / csteps, c0 = (s - tap * csteps) * CV_BK;
    const int dh = tap / KW - PH, dw = tap - (tap / KW) * KW - PW;
    const ptrdiff_t shift = ((ptrdiff_t)dh * W + dw) * Cin;
#pragma unroll
    for (int i = 0; i < T::A_IT; ++i) {
      const int r = (tid + i * T::THREADS) >> 2;
      const int ih = a_oh[i] + dh, iw = a_ow[i] + dw, c = c0 + a_q;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      unsigned char* dst = as + cv_swz(r, tid & 3);
      const __nv_bfloat16* src = x + a_pix[i] + shift + c;
      if (vec_a) {
        const bool ok = in && c < Cin;
        cp_async16(dst, ok ? (const void*)src : (const void*)x, ok ? 16 : 0);
      } else {
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = (in && c + e < Cin) ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    const uint8_t* wrow = wp + ((size_t)tap * Cin + c0) * nbytes;
    for (int id = tid; id < T::WCH; id += T::THREADS) {
      const int r = id / (BN / 32), cb = (id % (BN / 32)) * 16;
      const int jb = (n_base >> 1) + cb;
      const bool kin = c0 + r < Cin;
      uint8_t* dst = wsb + r * (BN / 2) + cb;
      if (vec_b) {
        const int bytes = kin ? max(0, min(16, nbytes - jb)) : 0;
        cp_async16(dst, bytes ? wrow + (size_t)r * nbytes + jb : wp, bytes);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (kin && jb + e < nbytes) ? wrow[(size_t)r * nbytes + jb + e]
                                            : (uint8_t)0;
      }
    }
  };

  // ring stage st of step s -> Bs[buf] (dequantized, 0 past Cin and N)
  auto convert = [&](int st, int s, int buf) {
    BTile* Bb = Bs + buf * CV_BK;
    const uint8_t* wsb = smem + st * T::STAGE + T::A_BYTES;
    const int c0 = (s % csteps) * CV_BK;
#pragma unroll
    for (int i = 0; i < T::B_ROWS; ++i) {
      const int r = b_r0 + i * T::B_RSTEP;
      const uint32_t b = wsb[r * (BN / 2) + jbl];
      const uint32_t w0 = lut[(b & 15u) * BN + 2 * jbl];
      const uint32_t w1 = lut[(b >> 4) * BN + 2 * jbl + 1];
      *reinterpret_cast<uint32_t*>(&Bb[r][2 * jbl]) =
          c0 + r < Cin ? (w0 | (w1 << 16)) : 0u;
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
  // one barrier (its tiles are visible; every warp is done with the
  // products of step s-1, so Bs[(s+1)&1] and ring stage (s+3)%4 are
  // free), dequantize step s+1's bytes, refill stage (s+3)%4 with step
  // s+3, and run the products of step s (A from ring stage s%4).
  static_assert(CV_STAGES == 4, "the loop below keeps three steps ahead");
  for (int s = 0; s < 3; ++s) {
    if (s < nsteps) issue(s, s_begin + s);
    cp_async_commit();
  }
  cp_async_wait<2>();
  __syncthreads();  // step 0 and the table
  convert(0, s_begin, 0);
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s + 1 < nsteps) convert((s + 1) & 3, s_begin + s + 1, (s + 1) & 1);
    if (s + 3 < nsteps) issue((s + 3) & 3, s_begin + s + 3);
    cp_async_commit();
    const unsigned char* Ab = smem + (s & 3) * T::STAGE;
    const BTile* Bb = Bs + (s & 1) * CV_BK;
#pragma unroll
    for (int kk = 0; kk < CV_BK; kk += 16) {
      uint32_t af[T::MI][4], bfr[T::NJ][2];
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
        ldsm_x4(af[i], Ab + cv_swz(wm + i * 16 + (lane & 15),
                                   kk / 8 + (lane >> 4)));
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
  store_tile<T::MI, T::NJ>(
      [&](int i, int j, int e) { return acc[i][j][e]; }, out, ws, bias, M, N,
      m_base + wm, n_base + wn, g, t4);
}


// ---------------------------------------------------------------------------
// The conv's wgmma route: a pre-pass dequantizes the packed weights once a
// call into a bf16 (N, K) buffer, K-major (int4_conv_dequant_kernel); the
// conv then runs on blocks of 128 pixels x 192 channels, two warpgroups of
// 64 pixels issuing wgmma m64n192k16 (bf16, f32 accumulators) with both
// operands in shared memory. K steps of one tap and CW_BK = 64 input
// channels, so every operand row is one 128-byte swizzle row (chunk c of
// row r at c ^ (r & 7), the layout the int8 GEMM's wgmma reads): the A
// tile [128][64] gathered as on the mma.sync route and the weight tile
// [192][64], both by cp.async into a CW_STAGES ring loaded three steps
// ahead. At step s the barrier finds every warpgroup past its wait for
// step s - 2's products, so the stage they read is free for step s + 3.
// ---------------------------------------------------------------------------

constexpr int CW_BK = 64;
constexpr int CW_STAGES = 5;
constexpr int CW_BN = 192;

struct ConvWgTile {
  static constexpr int BM = 128, BN = CW_BN, THREADS = 256, NR = BN / 2;
  static constexpr int A_BYTES = BM * CW_BK * 2;
  static constexpr int B_BYTES = BN * CW_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = CW_STAGES * STAGE + 1024;   // + alignment
  static constexpr int A_IT = BM * 8 / THREADS;   // 16-byte chunks of A
  static constexpr int B_CH = BN * 8;             // 16-byte chunks of w
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0, "alignment");
  static_assert(A_IT * THREADS == BM * 8, "A loader");
  static_assert(SMEM <= 232448, "shared memory");
};

// byte offset of 16-byte chunk c (0..7) of row r in a [rows][128-byte]
// tile, the 128-byte swizzle
__device__ __forceinline__ int cw_swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, groups of 8
// rows 1024 bytes apart (tile bases 1024-byte aligned; a k16 step within
// the row advances the start address by 32 bytes)
__device__ __forceinline__ uint64_t cw_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_bf16_n192(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// The pre-pass of the wgmma route with dequantized weights: w (K =
// taps * Cin rows, ceil(N/2) bytes) -> wdq (N, K) bf16, K-major, by the
// conv's rule. A block takes 64 rows of K x 128 channels: coalesced byte
// loads, two lookups a byte into a [128][64] tile, 16-byte row stores.
__global__ void __launch_bounds__(256)
int4_conv_dequant_kernel(const uint8_t* __restrict__ wp,
                         const float* __restrict__ delta,
                         const float* __restrict__ zpc,
                         __nv_bfloat16* __restrict__ wdq, int K, int N) {
  __shared__ uint16_t lut[16][128];
  __shared__ __align__(16) uint16_t tile[128][64 + 8];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * 128;
  const int nbytes = (N + 1) >> 1;
  for (int i = tid; i < 16 * 128; i += 256) {
    const int v = i >> 7, n = n0 + (i & 127);
    float w = 0.f;
    if (n < N) w = ((float)((v ^ 8) - 8) - zpc[n]) * delta[n];
    lut[v][i & 127] = __bfloat16_as_ushort(__float2bfloat16_rn(w));
  }
  __syncthreads();
  const int j = tid & 63, jb = (n0 >> 1) + j;
#pragma unroll 4
  for (int r = tid >> 6; r < 64; r += 4) {
    const int k = k0 + r;
    const uint32_t b = (k < K && jb < nbytes) ? wp[(size_t)k * nbytes + jb] : 0;
    tile[2 * j][r] = lut[b & 15u][2 * j];
    tile[2 * j + 1][r] = lut[b >> 4][2 * j + 1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + 256 * i, n = id >> 3, c = id & 7;
    if (n0 + n < N && k0 + 8 * c < K)
      *reinterpret_cast<uint4*>(wdq + (size_t)(n0 + n) * K + k0 + 8 * c) =
          *reinterpret_cast<const uint4*>(&tile[n][8 * c]);
  }
}

__global__ void __launch_bounds__(256, 1)
int4_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wdq,
                       const float* __restrict__ bias,
                       float* __restrict__ out, float* __restrict__ ws,
                       int B, int H, int W, int Cin, int N, int KW, int PH,
                       int PW, int Ho, int Wo, int nsteps_all, int spc,
                       int vec_a) {
  using T = ConvWgTile;
  constexpr int BN = T::BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wl = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = B * Ho * Wo;
  const int m_base = blockIdx.y * T::BM, n_base = blockIdx.x * BN;
  const int s_begin = blockIdx.z * spc;
  const int nsteps = min(nsteps_all, s_begin + spc) - s_begin;
  const int csteps = Cin / CW_BK;
  const size_t kt = (size_t)(nsteps_all / csteps) * Cin;   // wdq's row

  // this thread's A chunks: chunk tid & 7 (channels 8 (tid & 7) .. + 7 of
  // the step's) of rows (tid >> 3) + 32 i, one pixel each
  int a_oh[T::A_IT], a_ow[T::A_IT];
  size_t a_pix[T::A_IT];
#pragma unroll
  for (int i = 0; i < T::A_IT; ++i) {
    const int m = m_base + (tid >> 3) + 32 * i;
    const int mm = m < M ? m : 0;
    const int b = mm / (Ho * Wo), rem = mm - b * Ho * Wo;
    a_oh[i] = m < M ? rem / Wo : -(1 << 20);   // rows past M: never inside
    a_ow[i] = rem - (rem / Wo) * Wo;
    a_pix[i] = (((size_t)b * H + rem / Wo) * W + a_ow[i]) * Cin;
  }

  // step s -> ring stage st: the A tile and rows n_base .. + 191 of wdq
  auto issue = [&](int st, int s) {
    unsigned char* as = smem + st * T::STAGE;
    unsigned char* bs = as + T::A_BYTES;
    const int tap = s / csteps, c0 = (s - tap * csteps) * CW_BK;
    const int dh = tap / KW - PH, dw = tap - (tap / KW) * KW - PW;
    const ptrdiff_t shift = ((ptrdiff_t)dh * W + dw) * Cin;
    const int c = c0 + 8 * (tid & 7);
#pragma unroll
    for (int i = 0; i < T::A_IT; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const int ih = a_oh[i] + dh, iw = a_ow[i] + dw;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      unsigned char* dst = as + cw_swz(r, tid & 7);
      const __nv_bfloat16* src = x + a_pix[i] + shift + c;
      if (vec_a) {
        cp_async16(dst, in ? (const void*)src : (const void*)x, in ? 16 : 0);
      } else {
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = in ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    const __nv_bfloat16* wrow = wdq + (size_t)tap * Cin + c0;
    for (int id = tid; id < T::B_CH; id += T::THREADS) {
      const int r = id >> 3, cc = id & 7;
      const bool ok = n_base + r < N;
      cp_async16(bs + cw_swz(r, cc),
                 ok ? (const void*)(wrow + (n_base + r) * kt + 8 * cc)
                    : (const void*)wdq,
                 ok ? 16 : 0);
    }
  };

  float acc[T::NR];
#pragma unroll
  for (int i = 0; i < T::NR; ++i) acc[i] = 0.f;

  static_assert(CW_STAGES == 5,
                "loads three steps ahead, one step's products in flight");
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s < nsteps) issue(s, s_begin + s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<2>();
    // this thread's copies (and element stores), seen by the async proxy
    // that wgmma reads with
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // step s landed; step s - 2's products are done
    if (s + 3 < nsteps) issue((s + 3) % CW_STAGES, s_begin + s + 3);
    cp_async_commit();
    const unsigned char* As =
        smem + (s % CW_STAGES) * T::STAGE + wg * 64 * 128;
    const unsigned char* Bs = smem + (s % CW_STAGES) * T::STAGE + T::A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < CW_BK / 16; ++kk)
      wgmma_bf16_n192(acc, cw_desc(As + 32 * kk), cw_desc(Bs + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();

  // accumulator 4 j + e of the warpgroup's 64 x BN tile: row 16 wl + g
  // (+ 8 for e >= 2), column 8 j + 2 t4 + (e & 1), mma.sync's layout of
  // a warp's 16 rows
  store_tile<1, BN / 8>(
      [&](int, int j, int e) { return acc[4 * j + e]; }, out, ws, bias, M, N,
      m_base + 64 * wg + 16 * wl, n_base, g, t4);
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

// wgmma = 0: the mma.sync route, (bm, bn) 128 x 128 or 128 x 64, K steps
// of one tap and 32 channels; wgmma = 1: the wgmma route, 128 x 192,
// steps of one tap and 64 channels (Cin % 64 == 0), after the pre-pass
// that dequantizes the weights into wdq (N, KH*KW*Cin) bf16.
// The KH*KW*ceil(Cin/step) steps in `splits` ranges of `spc` steps
// (blockIdx.z), partial sums in ws (splits, M, N) when splits > 1.
int tfmq_int4_conv2d(const void* x, const void* w_packed, const void* delta,
                     const void* zp_c, const void* bias, void* out, void* ws,
                     void* wdq, int B, int H, int W, int Cin, int N, int KH,
                     int KW,
                     int PH, int PW, int wgmma, int bm, int bn, int splits,
                     int spc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Ho = H + 2 * PH - KH + 1;
  const int Wo = W + 2 * PW - KW + 1;
  const long long M = (long long)B * Ho * Wo;
  const int bk = wgmma ? CW_BK : CV_BK;
  const long long Kt = (long long)KH * KW * Cin;
  const int nsteps = KH * KW * ((Cin + bk - 1) / bk);
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || N <= 0 || M > INT32_MAX ||
      splits < 1 || spc < 1 || (long long)spc * (splits - 1) >= nsteps ||
      (long long)spc * splits < nsteps || (splits > 1 && !ws) ||
      (M + 63) / 64 > 65535 || splits > 65535 ||
      (wgmma && (!wdq || Cin % CW_BK || Kt > INT32_MAX)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nbytes = (N + 1) >> 1;
  const int vec_a = (Cin % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_b = (nbytes % 16 == 0) && ((uintptr_t)w_packed % 16 == 0);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const uint8_t* wb = (const uint8_t*)w_packed;
  const float *df = (const float*)delta, *zf = (const float*)zp_c,
              *bf = (const float*)bias;
  float *of = (float*)out, *wsf = (float*)ws;
#define TFMQ_CONV(BM, BN, WM, WN)                                            \
  do {                                                                       \
    using T = ConvTile<BM, BN, WM, WN>;                                      \
    static tfmq::SmemAttr attr;                                              \
    const int e = tfmq::raise_smem(int4_conv_kernel<BM, BN, WM, WN>, attr,   \
                                   T::SMEM);                                 \
    if (e) return e;                                                         \
    dim3 grid((N + BN - 1) / BN, (int)((M + BM - 1) / BM), splits);          \
    int4_conv_kernel<BM, BN, WM, WN><<<grid, T::THREADS, T::SMEM, s>>>(      \
        xb, wb, df, zf, bf, of, wsf, B, H, W, Cin, N, KW, PH, PW, Ho, Wo,    \
        nsteps, spc, vec_a, vec_b);                                          \
  } while (0)
  if (wgmma) {   // the weights dequantized once, then the conv
    if (bm != 128 || bn != CW_BN) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* wq = (__nv_bfloat16*)wdq;
    dim3 pg((int)((Kt + 63) / 64), (N + 127) / 128);
    int4_conv_dequant_kernel<<<pg, 256, 0, s>>>(wb, df, zf, wq, (int)Kt, N);
    static tfmq::SmemAttr attr;
    const int e = tfmq::raise_smem(int4_conv_wgmma_kernel, attr,
                                   ConvWgTile::SMEM);
    if (e) return e;
    dim3 grid((N + CW_BN - 1) / CW_BN, (int)((M + 127) / 128), splits);
    int4_conv_wgmma_kernel<<<grid, 256, ConvWgTile::SMEM, s>>>(
        xb, wq, bf, of, wsf, B, H, W, Cin, N, KW, PH, PW, Ho, Wo, nsteps,
        spc, vec_a);
  } else if (bm == 128 && bn == 128) {
    TFMQ_CONV(128, 128, 2, 4);
  } else if (bm == 128 && bn == 64) {
    TFMQ_CONV(128, 64, 4, 2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef TFMQ_CONV
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  int4_linear_reduce<<<blocks, 256, 0, s>>>(wsf, bf, of, (int)M, N, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
