// Flash-attention kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see ops/flash_attention.py).
//
// Counterparts of the Pallas kernels in tfmq_dm_tpu/ops/flash_attention.py:
//   tfmq_flash_f32  pquant 0 (fp)    <- _fp_kernel
//                   pquant 1         <- _quant_kernel
//   tfmq_flash_int8 (int8)           <- _int8_kernel
//   tfmq_flash_fqk  (fqk)            <- _fqk_kernel
//
// Layout: (B*H, T, D) row-major, no tile padding in device memory (the
// scratch of the int8 and fqk pre-passes is padded); the ragged key and
// query edges are masked in the kernels, and the head dim is zero-filled
// up to the kernel's template width in shared memory only.
//
// Softmax-output quantization (pquant, and int8 and fqk with a p
// quantizer) needs the exact normalized probabilities, which the online
// rescaling cannot give. The Pallas kernels cache e = exp(s - m) in a
// (block_q, Tk) f32 scratch; at Tk = 1024 that is 128 KB for 32 rows and
// 256 KB for 64, beyond what a block can hold here. These kernels
// recompute the scores in a second pass instead: pass 1 gives the row max
// m and the denominator l online, and the running max m_b at the end of
// each key block of bk columns (the Pallas call's block_k, 2048 by
// default); pass 2 recomputes s bit for bit (same code, same order),
// takes e = exp(s - m_b) against its block's max and quantizes round(e f)
// with the row factor f = exp(m_b - m) / (l delta): the Pallas kernels'
// own operand, block by block (flash_attention.py:134-163). The block
// maxes live in shared memory (MAX_KB blocks at most). The plain versions
// in ops/flash_attention.py take exactly this rounding.
//
// int8 (flash_i8_kernel<DP, PQ>): q/k/v arrive as centered int8 codes,
// quantized outside with their row sums. What bounds it on this card: at
// cin256 (B*H 4, T 1024, D 384) one S and one P @ V are 6.4 G int8
// operations on 11 MB of codes, sums and f32 output, 0.0033 ms either way
// at 1979 TOP/s and 3.35 TB/s; in practice the K and V tiles each block
// streams through shared memory (once per pass) and the latency of the
// per-tile steps. Its first version ran S on dp4a and P @ V as scalar
// integer FMA in blocks of 32 rows. This one:
//   - a pre-pass kernel (i8_vt_kernel, one launch per call, counted in
//     the kernel's time) transposes the v codes once into scratch (B*H,
//     DP, Tk padded to 64), zero past Tk and D: each head-dim column's
//     codes over the keys, the layout of the s8 B operand of P @ V. (A
//     byte transpose in shared memory would repeat it in every block.)
//   - a block holds RG row groups of 16 query rows; the NC warps of a row
//     group split the key tile for S and the head dim for P @ V. Each warp
//     keeps its rows' Q codes as ldmatrix A fragments in registers; K
//     codes and their row sums come through a two-stage cp.async ring;
//     S = Q K^T runs on mma.sync m16n8k32 s8 (int32 sums, exact in any
//     order), the head dim padded with zero codes to DP, a multiple of
//     32, in shared memory (a zero code adds 0; the corrections keep the
//     real D). The zero-point corrections dq dk (acc - zk' sum q - zq'
//     sum k + D zq' zk') sm_scale are taken in the Pallas kernel's order
//     without contraction (__fmul_rn / __fsub_rn): S is the plain
//     version's bit for bit, and pass 2's is pass 1's.
//   - PQ, the softmax quantizer (the cin256 int4-serving path's mode):
//     the two passes above; pass 2 writes the levels - 128 as int8
//     through shared memory (the s32 C layout is not the s8 A layout) and
//     runs P @ V on m16n8k32 s8 against the v codes (int32 sums: |level
//     code| <= 2^14, exact for Tk < 2^17); the rank-1 corrections of the
//     zero points are folded over the real keys in 64-bit integers.
//     Exact: the outputs differ from the plain version's only where the
//     f32 softmax denominator, summed in another order, flips a level
//     (the one-level rule).
//   - no quantizer: one online pass; each tile's row max is taken over
//     the group's warps through shared memory, p = exp(s - m) is split
//     hi + lo (TF32, as for pquant below) into f32 planes, and P @ V runs
//     on mma.sync m16n8k8 TF32 against (v' - zv'): an integer below 2^9,
//     exact in TF32, where zv is an integer (two products, p_hi and
//     p_lo), else split hi + lo too (three: hi hi + hi lo + lo hi); dv
//     and 1 / l apply per output. Error: p carried to 2^-22, f32 sums;
//     the plain version rounds dv (v' - zv') per element, the kernel
//     per output: within 2e-5 of the output's largest magnitude
//     (2.2e-6 at cin256, 7.5e-6 at SD's 64x64 on an H100).
//
// fp (flash_fp_kernel<DP>, f32 q/k/v): at cin256 one S and one P @ V are
// 6.4 GFLOP on 25 MB, so the tensor cores bound it (0.013 ms at the 495
// TFLOP/s TF32 rate; one TF32 or bf16 product would move s by ~1e-3
// relative, beyond the 2e-5 rule). Its first version ran both products as
// scalar f32 FMA. This one takes flash_pquant's blocking below (FpCfg:
// NC warps share a 16-row group and split its head dim) in one pass:
//   - S on three mma.sync m16n8k8 TF32 products of hi / lo splits (K
//     fragments by ldmatrix, split as read), the group's NC partials
//     added through shared memory in warp order;
//   - a row-per-lane online softmax: each row's denominator is rescaled
//     by alpha = exp(m_old - m_new) and alpha goes through shared memory
//     to the warps, which rescale their O columns;
//   - P @ V on three TF32 products, p_hi v_hi + p_hi v_lo + p_lo v_hi,
//     p split as written and v as read.
//   Error: S to about 2^-21 of sum |q||k|, p and v to 2^-22, f32 sums:
//   within 2e-5 (3.7e-6 at cin256, 1.1e-5 at SD's 64x64). Splitting K
//   once per call into hi / lo planes with a pre-pass (no split in the S
//   chain, K ring traded for one tile of two planes) was measured slower
//   on an H100 (0.2049 against 0.1982 ms at cin256, 1.737 against 1.597
//   at SD's 64x64): split on read stays.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_KB = 64;    // key blocks whose maxes a block keeps

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

template <int DP, class Cfg = PqCfg<DP>>
struct PqShape {
  static constexpr int NC = Cfg::NC, RG = Cfg::RG, BK = 32;
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

// ---------------------------------------------------------------------------
// int8: centered int8 codes; S on mma.sync m16n8k32 s8, P @ V on the same
// s8 mma (softmax quantizer) or on TF32 (none)
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

// G bytes global -> shared, zero-filled where !in (cp.async takes 4, 8 or
// 16 bytes; .cg only 16)
template <int G>
__device__ __forceinline__ void cp_async_g(void* dst, const void* src,
                                           bool in) {
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(G), "r"(in ? G : 0));
}

template <int G, int DP>
__device__ __forceinline__ void load_i8_rows_g(int8_t* dst, int pitch,
                                               const int8_t* src, int r0,
                                               int nrows, int total, int d,
                                               int tid, int nthr) {
  constexpr int NG = DP / G;
  for (int i = tid; i < nrows * NG; i += nthr) {
    const int r = i / NG, c = (i - r * NG) * G;
    const int row = r0 + r;
    const bool in = row < total && c < d;
    cp_async_g<G>(dst + r * pitch + c, in ? src + (size_t)row * d + c : src,
                  in);
  }
}

// rows [r0, r0 + nrows) of a (total, d) int8 matrix into shared memory
// (row pitch `pitch`, DP bytes a row), zero past `total` rows and past
// column d: cp.async in granules of `gran` bytes (d and the base a
// multiple of it), else byte by byte
template <int DP>
__device__ __forceinline__ void load_i8_rows(int8_t* dst, int pitch,
                                             const int8_t* src, int r0,
                                             int nrows, int total, int d,
                                             int gran, int tid, int nthr) {
  if (gran == 16) {
    load_i8_rows_g<16, DP>(dst, pitch, src, r0, nrows, total, d, tid, nthr);
  } else if (gran == 8) {
    load_i8_rows_g<8, DP>(dst, pitch, src, r0, nrows, total, d, tid, nthr);
  } else if (gran == 4) {
    load_i8_rows_g<4, DP>(dst, pitch, src, r0, nrows, total, d, tid, nthr);
  } else {
    for (int i = tid; i < nrows * DP; i += nthr) {
      const int r = i / DP, c = i - r * DP;
      const int row = r0 + r;
      dst[r * pitch + c] =
          (row < total && c < d) ? src[(size_t)row * d + c] : int8_t(0);
    }
  }
}

// Keys of the v-code scratch are padded to I8_KPAD (a multiple of every
// key tile); a pre-pass block takes I8_KPAD keys x I8_PD columns.
constexpr int I8_KPAD = 64;
constexpr int I8_PD = 64;
constexpr int I8_PRE_THREADS = 256;

// v codes (B*H, Tk, d) -> vt (B*H, DP, Tkp): each head-dim column's codes
// over the keys (the s8 B operand of P @ V, keys contiguous), zero past
// tk and d. One block: 64 keys x 64 columns through shared memory.
__global__ void __launch_bounds__(I8_PRE_THREADS)
i8_vt_kernel(const int8_t* __restrict__ v8, int8_t* __restrict__ vt, int tk,
             int tkp, int d, int dp) {
  __shared__ __align__(16) int8_t tile[I8_PD][I8_KPAD + 16];
  const int bh = blockIdx.z, t0 = blockIdx.x * I8_KPAD;
  const int c_base = blockIdx.y * I8_PD;
  const int8_t* vb = v8 + (size_t)bh * tk * d;
  for (int i = threadIdx.x; i < I8_KPAD * I8_PD; i += I8_PRE_THREADS) {
    const int r = i / I8_PD, cl = i % I8_PD;
    const int key = t0 + r, col = c_base + cl;
    tile[cl][r] = (key < tk && col < d) ? vb[(size_t)key * d + col]
                                        : int8_t(0);
  }
  __syncthreads();
  // thread: column cl = tid / 4, keys 16 q4 .. 16 q4 + 15
  const int cl = threadIdx.x >> 2, q4 = threadIdx.x & 3;
  const int col = c_base + cl;
  if (col < dp)
    *reinterpret_cast<uint4*>(vt + ((size_t)bh * dp + col) * tkp + t0 +
                              q4 * 16) =
        *reinterpret_cast<const uint4*>(&tile[cl][q4 * 16]);
}

// Per padded head dim (d rounded up to 64, 96, 160 or 384, multiples of
// the s8 mma's depth 32): NC warps share a row group of 16 query rows
// (they split the key tile for S and the head dim for P @ V), RG row
// groups a block, key tiles of BK.
template <int DP, bool PQ> struct I8Cfg;
template <bool PQ> struct I8Cfg<64, PQ> {
  static constexpr int NC = 1, RG = 4, BK = PQ ? 64 : 32;
};
template <bool PQ> struct I8Cfg<96, PQ> {
  static constexpr int NC = 1, RG = 4, BK = PQ ? 64 : 32;
};
template <bool PQ> struct I8Cfg<160, PQ> {
  static constexpr int NC = 2, RG = 2, BK = 64;
};
template <bool PQ> struct I8Cfg<384, PQ> {
  static constexpr int NC = 4, RG = 2, BK = 64;
};

template <int DP, bool PQ>
struct I8Shape {
  static constexpr int NC = I8Cfg<DP, PQ>::NC, RG = I8Cfg<DP, PQ>::RG,
                       BK = I8Cfg<DP, PQ>::BK;
  static constexpr int THREADS = 32 * NC * RG;
  static constexpr int BQ = 16 * RG;   // query rows a block
  static constexpr int KW = BK / NC;   // keys a warp scores per tile
  static constexpr int NJ = KW / 8;    // its n8 tiles of S
  static constexpr int DC = DP / NC;   // head-dim columns a warp owns
  static constexpr int KS = DP / 32;   // k32 steps of S
  // byte pitches of the Q / K rows and of the v-code rows and int8 P tile
  // (odd multiples of 16: ldmatrix rows hit distinct banks); word pitch
  // of the f32 P planes (8 mod 32: conflict-free float2 fragment reads)
  static constexpr int QP = DP + 16, BP = BK + 16, PP = BK + 8;
  static constexpr int Q_BYTES = BQ * QP;
  static constexpr int K_BYTES = BK * QP;   // a stage
  static constexpr int V_BYTES = DP * BP;   // a stage
  // the key sums of a K stage (f32)
  static constexpr int KSUM_BYTES = BK * 4;
  // a row group's P: int8 levels [16][BP], or f32 hi / lo planes [2][16][PP]
  static constexpr int P_BYTES = RG * (PQ ? 16 * BP : 2 * 16 * PP * 4);
  // bytes of shared memory for nkb key blocks (the block maxes last)
  static constexpr int smem(int nkb) {
    return Q_BYTES + 2 * (K_BYTES + KSUM_BYTES) + 2 * V_BYTES + P_BYTES +
           4 * (3 * NC * BQ + (PQ ? NC * BQ * nkb : 0));
  }
  static_assert(KW % 8 == 0 && DC % 16 == 0 && BK % 32 == 0, "tiles");
  static_assert(I8_KPAD % BK == 0 && DP % 32 == 0, "padding");
};

// Attention on centered int8 codes. q8, k8 (B*H, T, d); vt the v codes
// transposed (B*H, DP, Tkp) from i8_vt_kernel; qsum, ksum the code row
// sums; vsum the v code column sums over the real keys; sc = [dq, zq, dk,
// zk, dv, zv, dw, zw]. PQ: the softmax quantizer's levels (two passes,
// per-key-block rounding, integer P @ V with exact corrections); else one
// online pass with p f32 against (v' - zv') on TF32.
template <int DP, bool PQ>
__global__ void __launch_bounds__(I8Shape<DP, PQ>::THREADS)
flash_i8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                const int8_t* __restrict__ vt,
                const float* __restrict__ qsum_g,
                const float* __restrict__ ksum_g,
                const int* __restrict__ vsum_g, const float* __restrict__ sc,
                float* __restrict__ o, int tq, int tk, int tkp, int d,
                int bk, float sm_scale, float wnb, float wpb, int gran) {
  using S = I8Shape<DP, PQ>;
  constexpr int NC = S::NC, BQ = S::BQ, BK = S::BK, KW = S::KW, NJ = S::NJ;
  constexpr int DC = S::DC, KS = S::KS, QP = S::QP, BP = S::BP, PP = S::PP;
  extern __shared__ __align__(16) unsigned char smem_u8[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_u8);          // [BQ][QP]
  int8_t* Ks = Qs + S::Q_BYTES;                             // [2][BK][QP]
  int8_t* Vs = Ks + 2 * S::K_BYTES;                         // [2][DP][BP]
  float* kss = reinterpret_cast<float*>(Vs + 2 * S::V_BYTES);  // [2][BK]
  unsigned char* Pt = reinterpret_cast<unsigned char*>(kss + 2 * BK);
  float* mred = reinterpret_cast<float*>(Pt + S::P_BYTES);      // [NC][BQ]
  float* lred = mred + NC * BQ;                                 // [NC][BQ]
  int* pred = reinterpret_cast<int*>(lred + NC * BQ);           // [NC][BQ]
  float* mpart = reinterpret_cast<float*>(pred + NC * BQ);  // [NC][BQ][nkb]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rgi = warp / NC, cw = warp % NC;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = rgi * 16;  // this warp's first row in the block
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const I8Scalars c = i8_scalars(sc, d);
  const int8_t* kbase = k8 + (size_t)bh * tk * d;
  const float* ksum = ksum_g + (size_t)bh * tk;
  // v-code rows P @ V reads: the head dim rounded up to 16
  const int dv16 = min(DP, (d + 15) & ~15);

  auto load_k = [&](int kt, int stage) {
    load_i8_rows<DP>(Ks + stage * S::K_BYTES, QP, kbase, kt * BK, BK, tk, d,
                     gran, tid, S::THREADS);
    if (tid < BK) {
      const int key = kt * BK + tid;
      cp_async4z(kss + stage * BK + tid, key < tk ? ksum + key : ksum,
                 key < tk ? 4 : 0);
    }
  };
  auto load_v = [&](int kt, int stage) {
    const int8_t* src = vt + (size_t)bh * DP * tkp + kt * BK;
    int8_t* dst = Vs + stage * S::V_BYTES;
    for (int i = tid; i < dv16 * (BK / 16); i += S::THREADS) {
      const int r = i / (BK / 16), cc = (i % (BK / 16)) * 16;
      cp_async16(dst + r * BP + cc, src + (size_t)r * tkp + cc);
    }
  };

  // this warp's Q code fragments (its 16 rows, all DP columns), once
  load_i8_rows<DP>(Qs, QP, q8 + (size_t)bh * tq * d, q0, BQ, tq, d, gran,
                   tid, S::THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qa[ks], Qs + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * QP +
                        ks * 32 + (lane >> 4) * 16);
  float qs_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + g + 8 * h;
    qs_r[h] = row < tq ? qsum_g[(size_t)bh * tq + row] : 0.f;
  }

  // S of this warp's 16 rows and its KW keys of tile kt (in `stage`):
  // s[j][e] is row g + 8 (e >> 1), key kt*BK + cw*KW + 8j + 2 t4 + (e & 1).
  // The int32 code products are exact in any order, and the zero-point
  // corrections dq dk (acc - zk' sum q - zq' sum k + D zq' zk') sm_scale
  // are taken in the Pallas kernel's order without contraction, so S is
  // the plain version's bit for bit, in both passes. (A warp with one n8
  // tile or two sums even and odd k32 steps in two chains.)
  constexpr int CH = NJ <= 2 && KS % 2 == 0 ? 2 : 1;
  static_assert(KS % CH == 0, "chains");
  float s[NJ][4];
  auto scores = [&](int stage, int kt) {
    int acc[CH][NJ][4];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ch][j][e] = 0;
    const int8_t* ks = Ks + stage * S::K_BYTES + cw * KW * QP;
#pragma unroll
    for (int k2 = 0; k2 < KS; k2 += CH)
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const int kk = (k2 + ch) * 32;
#pragma unroll
        for (int j = 0; j + 1 < NJ; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * QP + kk +
                         ((lane >> 3) & 1) * 16);
          mma_s8_16832(acc[ch][j], qa[k2 + ch], b);
          mma_s8_16832(acc[ch][j + 1], qa[k2 + ch], b + 2);
        }
        if constexpr (NJ % 2 == 1) {
          uint32_t b[2];
          ldsm_x2(b, ks + ((NJ - 1) * 8 + (lane & 7)) * QP + kk +
                         ((lane >> 3) & 1) * 16);
          mma_s8_16832(acc[ch][NJ - 1], qa[k2 + ch], b);
        }
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + cw * KW + j * 8 + 2 * t4 + (e & 1);
        const int a = CH == 2 ? acc[0][j][e] + acc[CH - 1][j][e]
                              : acc[0][j][e];
        const bool valid = key < tk;
        const float ksv =
            valid ? kss[stage * BK + cw * KW + j * 8 + 2 * t4 + (e & 1)]
                  : 0.f;
        float x = __fsub_rn((float)a, __fmul_rn(c.zk_c, qs_r[e >> 1]));
        x = __fsub_rn(x, __fmul_rn(c.zq_c, ksv));
        x = __fadd_rn(x, c.dzz);
        s[j][e] = valid ? __fmul_rn(__fmul_rn(c.dqdk, x), sm_scale)
                        : NEG_INF;
      }
  };
  auto key_ok = [&](int kt, int j, int e) {
    return (kt + 1) * BK <= tk ||
           kt * BK + cw * KW + j * 8 + 2 * t4 + (e & 1) < tk;
  };
  // a row's value over the row group's NC warps (their partials in
  // shared memory, warp order), after the group meets
  auto row_reduce_max = [&](float (&x)[2]) {
    if constexpr (NC > 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (t4 == 0) mred[cw * BQ + row0 + g + 8 * h] = x[h];
      rg_sync<NC>(rgi);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = mred[row0 + g + 8 * h];
#pragma unroll
        for (int cc = 1; cc < NC; ++cc)
          m = fmaxf(m, mred[cc * BQ + row0 + g + 8 * h]);
        x[h] = m;
      }
    }
  };

  const int nkt = (tk + BK - 1) / BK;
  using Acc = typename std::conditional<PQ, int, float>::type;
  Acc acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  float l_fin[2];   // without the quantizer: the rows' denominators
  int psum[2] = {0, 0};

  if constexpr (PQ) {
    const int nkb = ((nkt - 1) * BK) / bk + 1;
    // pass 1: each warp's running max and denominator over its keys, and
    // its running max at the end of each key block
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    load_k(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      cp_async_wait<0>();
      __syncthreads();   // K(kt) landed; tile kt - 1 is consumed
      if (kt + 1 < nkt) {
        load_k(kt + 1, (kt + 1) & 1);
        cp_async_commit();
      }
      scores(kt & 1, kt);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
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
      for (int cc = 1; cc < NC; ++cc) m = fmaxf(m, mred[cc * BQ + r]);
      float l = 0.f;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        l += lred[cc * BQ + r] * expf(mred[cc * BQ + r] - m);
      m_f[h] = m;
      inv[h] = 1.f / (l * c.dw);
    }
    for (int i = tid; i < BQ * nkb; i += S::THREADS) {
      const int r = i / nkb, kb = i - r * nkb;
      float mb = mpart[r * nkb + kb];
#pragma unroll
      for (int cc = 1; cc < NC; ++cc)
        mb = fmaxf(mb, mpart[(cc * BQ + r) * nkb + kb]);
      mpart[r * nkb + kb] = mb;
    }

    // pass 2: recompute S, the levels against their block's max, P
    // (levels - 128) through shared memory, P @ V on this warp's head-dim
    // columns on m16n8k32 s8 against the v codes
    int8_t* P8 = reinterpret_cast<int8_t*>(Pt) + rgi * 16 * BP;
    load_k(0, 0);
    load_v(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      const int st = kt & 1;
      cp_async_wait<0>();
      __syncthreads();   // tile kt landed; tile kt - 1 (and its P) consumed
      if (kt + 1 < nkt) {
        load_k(kt + 1, st ^ 1);
        load_v(kt + 1, st ^ 1);
        cp_async_commit();
      }
      scores(st, kt);
      const int kb = kt * BK / bk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mb = mpart[(row0 + g + 8 * h) * nkb + kb];
        const float f = __fmul_rn(expf(mb - m_f[h]), inv[h]);
        const int r = g + 8 * h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          int p8[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = rintf(__fmul_rn(expf(s[j][2 * h + e] - mb), f));
            const float pq = fminf(fmaxf(__fadd_rn(x, c.zw), wnb), wpb);
            p8[e] = key_ok(kt, j, e) ? (int)(pq - 128.f) : 0;
          }
          psum[h] += p8[0] + p8[1];
          *reinterpret_cast<uint16_t*>(P8 + r * BP + cw * KW + j * 8 +
                                       2 * t4) =
              (uint16_t)((uint8_t)(int8_t)p8[0] |
                         ((uint16_t)(uint8_t)(int8_t)p8[1] << 8));
        }
      }
      rg_sync<NC>(rgi);
      const int8_t* vs = Vs + st * S::V_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[4];
        ldsm_x4(a, P8 + ((lane & 7) + ((lane >> 3) & 1) * 8) * BP + kk +
                       (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < DC / 8; j += 2) {
          if (cw * DC + j * 8 >= d) continue;
          uint32_t b[4];
          ldsm_x4(b, vs + (cw * DC + j * 8 + (lane & 7) + (lane >> 4) * 8) *
                              BP +
                         kk + ((lane >> 3) & 1) * 16);
          mma_s8_16832(acc[j], a, b);
          mma_s8_16832(acc[j + 1], a, b + 2);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(FULL, psum[h], 1);
      psum[h] += __shfl_xor_sync(FULL, psum[h], 2);
    }
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) pred[cw * BQ + row0 + g + 8 * h] = psum[h];
    }
    __syncthreads();
  } else {
    // one online pass: the row max of each tile over the group's warps,
    // p = exp(s - m) split hi + lo into f32 planes, P @ V on TF32 against
    // (v' - zv'): exact integers below 2^9 where zv is an integer (two
    // products, p_hi and p_lo), else split too (three); dv in the epilogue
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    float* Ph = reinterpret_cast<float*>(Pt) + rgi * 2 * 16 * PP;
    float* Pl = Ph + 16 * PP;
    const bool zint = rintf(c.zv_c) == c.zv_c;
    const int zvi = (int)c.zv_c;
    // P @ V of one tile; ZI: integer zero point
    auto pv = [&](const int8_t* vs, auto zi) {
      constexpr bool ZI = decltype(zi)::value;
#pragma unroll
      for (int k8 = 0; k8 < BK / 8; ++k8) {
        // k index t4 <-> key 2 t4, t4 + 4 <-> key 2 t4 + 1 of the 8
        // (A and B alike): a0 / a2 and b0 / b1 are neighbouring keys
        uint32_t ah[4], al[4];
        const float2 h0 = *reinterpret_cast<const float2*>(
            Ph + g * PP + 8 * k8 + 2 * t4);
        const float2 h1 = *reinterpret_cast<const float2*>(
            Ph + (g + 8) * PP + 8 * k8 + 2 * t4);
        const float2 l0 = *reinterpret_cast<const float2*>(
            Pl + g * PP + 8 * k8 + 2 * t4);
        const float2 l1 = *reinterpret_cast<const float2*>(
            Pl + (g + 8) * PP + 8 * k8 + 2 * t4);
        ah[0] = __float_as_uint(h0.x); ah[1] = __float_as_uint(h1.x);
        ah[2] = __float_as_uint(h0.y); ah[3] = __float_as_uint(h1.y);
        al[0] = __float_as_uint(l0.x); al[1] = __float_as_uint(l1.x);
        al[2] = __float_as_uint(l0.y); al[3] = __float_as_uint(l1.y);
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          if (cw * DC + 8 * n >= d) continue;
          const uint32_t u = *reinterpret_cast<const uint16_t*>(
              vs + (cw * DC + 8 * n + g) * BP + 8 * k8 + 2 * t4);
          const int v0 = (int)(int8_t)(u & 0xffu);
          const int v1 = (int)(int8_t)(u >> 8);
          if constexpr (ZI) {
            const uint32_t b[2] = {__float_as_uint((float)(v0 - zvi)),
                                   __float_as_uint((float)(v1 - zvi))};
            mma_tf32_1688(acc[n], ah, b);
            mma_tf32_1688(acc[n], al, b);
          } else {
            uint32_t bh_[2], bl_[2];
            split_tf32(__fsub_rn((float)v0, c.zv_c), bh_[0], bl_[0]);
            split_tf32(__fsub_rn((float)v1, c.zv_c), bh_[1], bl_[1]);
            mma_tf32_1688(acc[n], ah, bh_);
            mma_tf32_1688(acc[n], ah, bl_);
            mma_tf32_1688(acc[n], al, bh_);
          }
        }
      }
    };
    load_k(0, 0);
    load_v(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      const int st = kt & 1;
      cp_async_wait<0>();
      __syncthreads();   // tile kt landed; tile kt - 1 (and its P) consumed
      if (kt + 1 < nkt) {
        load_k(kt + 1, st ^ 1);
        load_v(kt + 1, st ^ 1);
        cp_async_commit();
      }
      scores(st, kt);
      float mx[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          m = fmaxf(m, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
        mx[h] = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
      }
      row_reduce_max(mx);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_r[h], mx[h]);
        alpha[h] = expf(m_r[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float p[2];
          uint32_t hi[2], lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = key_ok(kt, j, e) ? expf(s[j][2 * h + e] - m_new) : 0.f;
            sum += p[e];
            split_tf32(p[e], hi[e], lo[e]);
          }
          const int off = (g + 8 * h) * PP + cw * KW + j * 8 + 2 * t4;
          *reinterpret_cast<float2*>(Ph + off) =
              make_float2(__uint_as_float(hi[0]), __uint_as_float(hi[1]));
          *reinterpret_cast<float2*>(Pl + off) =
              make_float2(__uint_as_float(lo[0]), __uint_as_float(lo[1]));
        }
        sum += __shfl_xor_sync(FULL, sum, 1);
        sum += __shfl_xor_sync(FULL, sum, 2);
        l_r[h] = l_r[h] * alpha[h] + sum;
        m_r[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      rg_sync<NC>(rgi);   // the group's P planes are written
      const int8_t* vs = Vs + st * S::V_BYTES;
      if (zint)
        pv(vs, std::true_type{});
      else
        pv(vs, std::false_type{});
    }
    // the rows' denominators: the warps' partials (one max) in warp order
    __syncthreads();
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) lred[cw * BQ + row0 + g + 8 * h] = l_r[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = 0.f;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) l += lred[cc * BQ + row0 + g + 8 * h];
      l_fin[h] = l;
    }
  }

  const long long zvc = __float2ll_rn(c.zv_c);
  const long long wz = 128 - __float2ll_rn(c.zw);
  const float dwdv = __fmul_rn(c.dw, c.dv);
  const bool pair = (d & 1) == 0;
  const int* vsum = vsum_g + (size_t)bh * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    const int row = q0 + r;
    if (row >= tq) continue;
    long long ps = 0;
    if constexpr (PQ) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) ps += pred[cc * BQ + r];
    }
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int col = cw * DC + j * 8 + 2 * t4;
      if (col >= d) continue;
      float val[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (PQ) {
          // sum over real keys of (p_q - zw)(v_q - zv), exact in 64 bits
          const long long vs = col + e < d ? vsum[col + e] : 0;
          const long long corr = (long long)acc[j][2 * h + e] - zvc * ps +
                                 wz * vs - wz * zvc * tk;
          val[e] = __fmul_rn(dwdv, (float)corr);
        } else {
          val[e] = __fmul_rn(c.dv, acc[j][2 * h + e]) / l_fin[h];
        }
      }
      if (pair && col + 1 < d) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(val[0], val[1]);
      } else {
        orow[col] = val[0];
        if (col + 1 < d) orow[col + 1] = val[1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp: f32 q/k/v, one online pass, S and P @ V on 3xTF32 mma.sync
// ---------------------------------------------------------------------------

// softmax(q k^T sm_scale) v over (B*H, T, d) f32, in the blocking of
// flash_pq_kernel (FpShape<DP>: NC warps share a 16-row group and split
// its head dim) with one pass: the row-per-lane softmax rescales its
// denominator online and hands each row's factor exp(m_old - m_new) to
// the warps through shared memory, which rescale their O columns.
// fp's blocking per padded head dim (as PqCfg's, but 4 row groups at d
// 40: measured faster at SD's 64x64)
template <int DP> struct FpCfg;
template <> struct FpCfg<40> { static constexpr int NC = 1, RG = 4; };
template <> struct FpCfg<80> { static constexpr int NC = 2, RG = 4; };
template <> struct FpCfg<160> { static constexpr int NC = 4, RG = 2; };
template <> struct FpCfg<384> { static constexpr int NC = 8, RG = 2; };
template <int DP> using FpShape = PqShape<DP, FpCfg<DP>>;

template <int DP>
__global__ void __launch_bounds__(FpShape<DP>::THREADS, 1)
flash_fp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int tq,
                int tk, int d, float sm_scale, int vec) {
  using S = FpShape<DP>;
  constexpr int NC = S::NC, BK = S::BK, RW = S::RW, DC = S::DC;
  constexpr int LPR = S::LPR, E = S::E;
  constexpr int KP = S::KP, VP = S::VP, SP = S::SP, PP = S::PP;
  extern __shared__ __align__(16) float smem_fp[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rgi = warp / NC, cw = warp % NC;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = rgi * 16;
  // the softmax step: lane -> row rl of the group, keys kl .. kl + E - 1
  const int rl = cw * RW + lane / LPR, kl = (lane % LPR) * E;
  float* kring = smem_fp;                              // [2][BK][KP]
  float* vbuf = kring + 2 * S::K_WORDS;                // [BK][VP]
  // this group's S partials [NC][16][SP], then its P planes
  float* grp = vbuf + S::V_WORDS + rgi * S::G_WORDS;
  float* ph = grp + NC * 16 * SP;                      // p, hi [16][PP]
  float* pl = ph + 16 * PP;                            // lo [16][PP]
  float* rowf = vbuf + S::V_WORDS + S::RG * S::G_WORDS;  // [BQ]

  const int bh = blockIdx.y, q0 = blockIdx.x * S::BQ;
  const float* qb = q + (size_t)bh * tq * d;
  const float* kbase = k + (size_t)bh * tk * d;
  const float* vbase = v + (size_t)bh * tk * d;
  const int nkt = (tk + BK - 1) / BK;

  // this warp's Q fragments (rows g, g + 8 of its group; its DC columns),
  // split once: a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, ..)
  uint32_t qh[DC / 8][4], ql[DC / 8][4];
#pragma unroll
  for (int s8 = 0; s8 < DC / 8; ++s8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + row0 + g + 8 * (e & 1);
      const int cc = cw * DC + 8 * s8 + t4 + 4 * (e >> 1);
      split_tf32((r < tq && cc < d) ? qb[(size_t)r * d + cc] : 0.f,
                 qh[s8][e], ql[s8][e]);
    }

  // BK rows of a (tk, d) operand from key tile kt, zero past tk and d
  auto load_rows = [&](float* dst, int pitch, const float* src, int kt) {
    for (int i = tid; i < BK * (DP / 4); i += S::THREADS) {
      const int r = i / (DP / 4), cc = (i - r * (DP / 4)) * 4;
      const int key = kt * BK + r;
      float* to = dst + r * pitch + cc;
      if (vec) {
        const bool in = key < tk && cc < d;
        cp_async16z(to, in ? src + (size_t)key * d + cc : src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = key < tk && cc + e < d;
          cp_async4z(to + e, in ? src + (size_t)key * d + cc + e : src,
                     in ? 4 : 0);
        }
      }
    }
  };

  // S of row rl and keys kt BK + kl + i (i < E) in s[i], scaled, NEG_INF
  // past tk. Each warp takes q k over its DC columns for all BK keys on
  // the tensor cores (K fragments by ldmatrix, split as read; hi hi in
  // one chain of f32 accumulators, the cross terms hi lo + lo hi in
  // another, added after), writes the partial, and adds the group's NC
  // partials of its rows in warp order.
  float s[E];
  auto scores = [&](const float* ks) {
    float shh[BK / 8][4], sx[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) shh[j][e] = sx[j][e] = 0.f;
    const float* kw = ks + cw * DC;
#pragma unroll
    for (int s8 = 0; s8 < DC / 8; ++s8)
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        // b[0], b[1]: keys 8j + g, columns t4 and t4 + 4; b[2], b[3]: j + 1
        uint32_t b[4];
        ldsm_x4(b, kw + (8 * j + (lane & 7) + (lane >> 4) * 8) * KP +
                       8 * s8 + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bh_[2], bl_[2];
          split_tf32(__uint_as_float(b[2 * jj]), bh_[0], bl_[0]);
          split_tf32(__uint_as_float(b[2 * jj + 1]), bh_[1], bl_[1]);
          mma_tf32_1688(shh[j + jj], qh[s8], bh_);
          mma_tf32_1688(sx[j + jj], qh[s8], bl_);
          mma_tf32_1688(sx[j + jj], ql[s8], bh_);
        }
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
      for (int cc = 1; cc < NC; ++cc) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(pr + cc * 16 * SP + i);
        a.x += b2.x;
        a.y += b2.y;
      }
      s[i] = a.x * sm_scale;
      s[i + 1] = a.y * sm_scale;
    }
  };

  float m_r = NEG_INF, l_r = 0.f;
  float oacc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  // K double-buffered; the V tile is loaded while S is computed
  load_rows(kring, KP, kbase, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // K(kt) landed; tile kt - 1's V, P and factors consumed
    load_rows(vbuf, VP, vbase, kt);
    cp_async_commit();
    const bool more = kt + 1 < nkt;
    if (more) {
      load_rows(kring + ((kt + 1) & 1) * S::K_WORDS, KP, kbase, kt + 1);
      cp_async_commit();
    }
    scores(kring + (kt & 1) * S::K_WORDS);
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (kt * BK + kl + i >= tk) s[i] = NEG_INF;
    float mx = s[0];
#pragma unroll
    for (int i = 1; i < E; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
    for (int off = LPR / 2; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m_r, mx);
    const float alpha = expf(m_r - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < E; i += 2) {
      uint32_t hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            kt * BK + kl + i + e < tk ? expf(s[i + e] - m_new) : 0.f;
        sum += p;
        split_tf32(p, hi[e], lo[e]);
      }
      const int off = rl * PP + kl + i;
      *reinterpret_cast<float2*>(ph + off) =
          make_float2(__uint_as_float(hi[0]), __uint_as_float(hi[1]));
      *reinterpret_cast<float2*>(pl + off) =
          make_float2(__uint_as_float(lo[0]), __uint_as_float(lo[1]));
    }
#pragma unroll
    for (int off = LPR / 2; off; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    l_r = l_r * alpha + sum;
    m_r = m_new;
    if (lane % LPR == 0) rowf[row0 + rl] = alpha;
    if (more)
      cp_async_wait<1>();   // V(kt); K(kt + 1) may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();        // V(kt), the group's P and factors are visible
    const float a0 = rowf[row0 + g], a1 = rowf[row0 + g + 8];
#pragma unroll
    for (int n8 = 0; n8 < DC / 8; ++n8) {
      oacc[n8][0] *= a0;
      oacc[n8][1] *= a0;
      oacc[n8][2] *= a1;
      oacc[n8][3] *= a1;
    }
    const float* vs = vbuf + cw * DC + g;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      uint32_t ah[4], al[4];
      const int poff = ((lane & 7) + ((lane >> 3) & 1) * 8) * PP + 8 * k8 +
                       (lane >> 4) * 4;
      ldsm_x4(ah, ph + poff);
      ldsm_x4(al, pl + poff);
#pragma unroll
      for (int n8 = 0; n8 < DC / 8; ++n8) {
        const float* vr = vs + (8 * k8 + t4) * VP + 8 * n8;
        uint32_t vh[2], vl[2];
        split_tf32(vr[0], vh[0], vl[0]);
        split_tf32(vr[4 * VP], vh[1], vl[1]);
        mma_tf32_1688(oacc[n8], ah, vh);
        mma_tf32_1688(oacc[n8], ah, vl);
        mma_tf32_1688(oacc[n8], al, vh);
      }
    }
  }

  // the rows' denominators to every warp of the group
  __syncthreads();
  if (lane % LPR == 0) rowf[row0 + rl] = l_r;
  __syncthreads();
  const bool pair = (d & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + g + 8 * h;
    if (row >= tq) continue;
    const float l = rowf[row0 + g + 8 * h];
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int n8 = 0; n8 < DC / 8; ++n8) {
      const int col = cw * DC + 8 * n8 + 2 * t4;
      const float v0 = oacc[n8][2 * h] / l;
      const float v1 = oacc[n8][2 * h + 1] / l;
      if (pair && col + 1 < d) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < d) orow[col] = v0;
        if (col + 1 < d) orow[col + 1] = v1;
      }
    }
  }
}

// a key block of bk columns is whole key tiles of every kernel (32 keys or
// a multiple), and at most MAX_KB of them
bool key_blocks_ok(int tk, int bk) {
  return bk > 0 && bk % 32 == 0 && (tk + bk - 1) / bk <= MAX_KB;
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

// the padded head dim the int8 kernel takes for d, or 0
int i8_dp(int d) {
  return d <= 0 ? 0 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 160 ? 160
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

template <int DP>
int launch_fp(const float* q, const float* k, const float* v, float* o,
              int bh, int tq, int tk, int d, float sm_scale,
              cudaStream_t stream) {
  using S = FpShape<DP>;
  static SmemAttr attr;
  const int e = raise_smem(flash_fp_kernel<DP>, attr, S::smem(1));
  if (e) return e;
  const int vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((tq + S::BQ - 1) / S::BQ, bh);
  flash_fp_kernel<DP><<<grid, S::THREADS, S::smem(1), stream>>>(
      q, k, v, o, tq, tk, d, sm_scale, vec);
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

// the largest cp.async granule (16, 8 or 4 bytes) that d and the bases
// of q8 and k8 allow, else 1 (bytewise)
int i8_granule(const void* q8, const void* k8, int d) {
  for (int gsz = 16; gsz >= 4; gsz >>= 1)
    if (d % gsz == 0 && (uintptr_t)q8 % gsz == 0 && (uintptr_t)k8 % gsz == 0)
      return gsz;
  return 1;
}

template <int DP, bool PQ>
int launch_i8(const int8_t* q8, const int8_t* k8, const int8_t* vt,
              const float* qsum, const float* ksum, const int* vsum,
              const float* sc, float* o, int bh, int tq, int tk, int tkp,
              int d, int bk, float sm_scale, float wnb, float wpb,
              cudaStream_t stream) {
  using S = I8Shape<DP, PQ>;
  static SmemAttr attr;
  const int e = raise_smem(flash_i8_kernel<DP, PQ>, attr, S::smem(MAX_KB));
  if (e) return e;
  if (bk % S::BK) return (int)cudaErrorInvalidValue;
  const int nkt = (tk + S::BK - 1) / S::BK;
  const int nkb = ((nkt - 1) * S::BK) / bk + 1;
  dim3 grid((tq + S::BQ - 1) / S::BQ, bh);
  flash_i8_kernel<DP, PQ><<<grid, S::THREADS, S::smem(nkb), stream>>>(
      q8, k8, vt, qsum, ksum, vsum, sc, o, tq, tk, tkp, d, bk, sm_scale, wnb,
      wpb, i8_granule(q8, k8, d));
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
#define TFMQ_FP(DP) \
  return launch_fp<DP>(qf, kf, vf, of, bh, tq, tk, d, sm_scale, s)
  switch (pq_dp(d)) {
    case 40: TFMQ_FP(40);
    case 80: TFMQ_FP(80);
    case 160: TFMQ_FP(160);
    case 384: TFMQ_FP(384);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFMQ_FP
}

// The int8 v-code pre-pass alone: vt (bh, dp, tkp) int8, the codes of v8
// (bh, tk, d) transposed, zero past tk and d; dp = the padded head dim,
// tkp = tk rounded up to 64.
int tfmq_int8_vt(const void* v8, void* vt, int bh, int tk, int d, int dp,
                 int tkp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bh <= 0 || bh > 65535 || tk <= 0 || dp != i8_dp(d) ||
      tkp != (tk + I8_KPAD - 1) / I8_KPAD * I8_KPAD)
    return (int)cudaErrorInvalidValue;
  dim3 grid(tkp / I8_KPAD, (dp + I8_PD - 1) / I8_PD, bh);
  i8_vt_kernel<<<grid, I8_PRE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)v8, (int8_t*)vt, tk, tkp, d, dp);
  return (int)cudaGetLastError();
}

// Pre-pass (v codes transposed into the caller's scratch vt, see above)
// and main kernel. quant_w: the softmax quantizer's levels on [wnb, wpb].
int tfmq_flash_int8(const void* q8, const void* k8, const void* v8,
                    const void* qsum, const void* ksum, const void* vsum,
                    const void* sc, void* o, void* vt, int bh, int tq,
                    int tk, int d, int dp, int tkp, int bk, float sm_scale,
                    int quant_w, float wnb, float wpb, int device,
                    void* stream) {
  if (!key_blocks_ok(tk, bk) || tq <= 0) return (int)cudaErrorInvalidValue;
  int err = tfmq_int8_vt(v8, vt, bh, tk, d, dp, tkp, device, stream);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t *qi = (const int8_t*)q8, *ki = (const int8_t*)k8,
               *vti = (const int8_t*)vt;
  const float *qsf = (const float*)qsum, *ksf = (const float*)ksum,
              *scf = (const float*)sc;
  const int* vsi = (const int*)vsum;
  float* of = (float*)o;
#define TFMQ_I8(DP)                                                          \
  return quant_w ? launch_i8<DP, true>(qi, ki, vti, qsf, ksf, vsi, scf, of,  \
                                       bh, tq, tk, tkp, d, bk, sm_scale, wnb, \
                                       wpb, s)                                \
                 : launch_i8<DP, false>(qi, ki, vti, qsf, ksf, vsi, scf, of, \
                                        bh, tq, tk, tkp, d, bk, sm_scale,    \
                                        wnb, wpb, s)
  switch (dp) {
    case 64: TFMQ_I8(64);
    case 96: TFMQ_I8(96);
    case 160: TFMQ_I8(160);
    case 384: TFMQ_I8(384);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFMQ_I8
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
