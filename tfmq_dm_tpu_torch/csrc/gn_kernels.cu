// Fused GroupNorm (+ scale-shift) + SiLU + per-tensor int8 activation
// quantization for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes; see ops/gn_kernels.py).
//
// Counterpart of gn_swish_quant_int8 in tfmq_dm_tpu/ops/pallas_kernels.py
// (_gn_sq_kernel, called through _gn_sq_call). NHWC x (B, HW, C), f32 or
// bf16, in; centered int8 codes (B, HW, C) and zp_c = zp - 2^(bits-1)
// out, the int8_conv2d input contract. The arithmetic is the Pallas
// kernel's, with its rounding points pinned one by one so that the plain
// version in ops/gn_kernels.py repeats them:
//   per-column f32 sums of x and x*x, folded into groups;
//   mean = gs1 * f32(1/n), var = max(gs2 * f32(1/n) - mean^2, 0),
//   n = HW * C / groups;
//   inv = rsqrt(var + eps) rounded once (__frsqrt_rn; rsqrtf is ~2 ulp);
//   a = inv * gamma, bb = beta - mean * a;
//   with the scale-shift pair (s, t): a * (1 + s), bb * (1 + s) + t;
//   y = x * a + bb, written __fadd_rn(__fmul_rn(.)) so that nvcc does not
//   contract it into an FMA;
//   SiLU y * (1 / (1 + expf(-y))) in f32 (expf, not __expf; the
//   reciprocal correctly rounded, see rcp_ge1);
//   code = clip(rint(y * (1/delta)) + zp, nb, pb) - off (rint rounds
//   half to even as jnp.round does; roundf would not; see gn_code).
// Only the order of the f32 sums differs from the plain version's. It is
// fixed (no atomics), so two calls give bit-identical codes.
//
// What bounds it on this card: bytes, in the ideal. At SD's (8, 64, 64,
// 320) in bf16 the function must read x once (21 MB) and write the codes
// once (10.5 MB): 31.5 MB, about 9.4 us at 3.35 TB/s. The statistics of a
// group need the whole batch row before the first code can be written, so
// the TPU kernel keeps a batch row in VMEM between its two passes
// (pallas_kernels.py:331-333). No block here can hold a row (2.6 MB at
// SD's 64x64), but a thread-block cluster can hold a slice of one in its
// blocks' shared memory. In practice the apply's instruction issue bounds
// it as much: with SiLU a code takes about 26 instructions at the rounding
// points above (expf, the reciprocal, the magic-number rounding), at
// least 9 us at SD's 64x64 on 132 SMs, and it cannot overlap the copies
// since each code waits on its group's statistics (PERF.md section 6 has
// the measured stages). Two routes, chosen from the shape alone by
// gn_plan in the wrapper:
//
// resident (one launch; x read from device memory once): one cluster of
//   K blocks (K <= 8) per (batch row, slice of whole groups whose rows
//   are a multiple of 4 bytes). The cluster's blocks split the HW rows and
//   hold them in shared memory. A block has 1024 threads (32 warps, so
//   that the apply hides its latency); 256 of them copy the block's rows
//   of x with cp.async, all of it in flight at once in 8 commit groups,
//   each thread one column chunk of 16 bytes (8 or 4 where the slice's
//   rows are narrower), and sum their own copies group by group as they
//   land, so no block barrier waits on the loads; the others fetch the
//   slice's gamma, beta and scale-shift pair. The lanes' column sums are
//   folded in a fixed order into per-group partials in shared memory;
//   after a cluster barrier every block reads all ranks' partials through
//   distributed shared memory in rank order and computes mean and inv;
//   then every thread folds the affine of its column chunk into registers
//   and writes the codes of its rows from shared memory, one store a
//   chunk. A last cluster barrier keeps each block resident until every
//   rank has read its partials. The plan keeps the clusters to as few
//   waves as it can: the card co-schedules 132 single blocks of this size,
//   66 clusters of 2, 30 of 4 and 15 of 8 (cudaOccupancyMaxActiveClusters
//   on an H100; ops/gn_kernels.py CLUSTER_SLOTS has every size).
// stream (two launches; x read twice): where no slice of whole groups fits
//   in a cluster's shared memory, gn_stream_stats sums x straight from
//   device memory (16-byte loads where the slice's rows allow, else one
//   value a load), reduces the statistics within the cluster the same
//   way and writes each channel's a and bb; gn_apply reads x again and
//   writes the codes.
//
// A cluster the card cannot schedule (the occupancy query finds none) or a
// failed launch returns an error; the wrapper raises. Nothing falls back.
//
// CUDA C++ rather than Triton, although the work is a reduction and an
// elementwise pass: each rounding point above has to be pinned one by one
// (no contraction, correctly rounded rsqrt, rint, expf), the statistics
// cross the cluster through distributed shared memory, and the port's
// other sources, their loader and their ptxas report are CUDA C++.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "smem_attr.cuh"

namespace cg = cooperative_groups;

namespace {

using tfmq::SmemAttr;
using tfmq::raise_smem;

constexpr int THREADS = 1024;        // a resident block: all apply
constexpr int LOADERS = 256;         // of them, those that copy and sum x
constexpr int IN_FLIGHT = 8;         // cp.async commit groups a loader
constexpr int STATS_THREADS = 512;   // the stream route's statistics block
constexpr int APPLY_THREADS = 256;   // the stream route's apply
// returned when the occupancy query finds no room for one cluster
constexpr int NO_CLUSTER_FITS = 100000;
// 1.5 * 2^23: v + MAGIC - MAGIC is rint(v) for |v| < 2^22
constexpr float MAGIC = 12582912.0f;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }

__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// n 32-bit words of x as f32: n floats or 2n bf16 (bf16 -> f32 is exact:
// a shift)
template <int N>
__device__ __forceinline__ void to_f32(const uint32_t* w, float* v,
                                       const float*) {
#pragma unroll
  for (int h = 0; h < N; ++h) v[h] = __uint_as_float(w[h]);
}

template <int N>
__device__ __forceinline__ void to_f32(const uint32_t* w, float* v,
                                       const __nv_bfloat16*) {
#pragma unroll
  for (int h = 0; h < N; ++h) {
    v[2 * h] = __uint_as_float(w[h] << 16);
    v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

// V consecutive values from p, one load of V * sizeof(T) bytes (aligned
// to it)
template <int V, typename T>
__device__ __forceinline__ void load_vals(const T* p, float* v) {
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    to_f32<4>(w, v, p);
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
    to_f32<2>(w, v, p);
  } else if constexpr (B == 4) {
    const uint32_t w[1] = {*reinterpret_cast<const uint32_t*>(p)};
    to_f32<1>(w, v, p);
  } else {
    v[0] = ld(p, 0);
  }
}

// the low bytes of 4 words, in order, in one word
__device__ __forceinline__ uint32_t pack4(const uint32_t* w) {
  return __byte_perm(__byte_perm(w[0], w[1], 0x0040),
                     __byte_perm(w[2], w[3], 0x0040), 0x5410);
}

// the low bytes of V words to out, one store of V bytes
template <int V>
__device__ __forceinline__ void store_codes(int8_t* out, const uint32_t* w) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(out) = make_uint2(pack4(w), pack4(w + 4));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(out) = pack4(w);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(out) =
        (uint16_t)__byte_perm(w[0], w[1], 0x0040);
  } else {
    *out = (int8_t)w[0];
  }
}

// an asynchronous copy of CB (16, 8 or 4) bytes from device to shared
// memory (16 bypasses L1)
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(CB)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (< IN_FLIGHT) of this thread's groups are pending
template <int N = IN_FLIGHT - 1>
__device__ __forceinline__ void cp_async_wait(int n) {
  if constexpr (N > 0) {
    if (n < N) {
      cp_async_wait<N - 1>(n);
      return;
    }
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

struct Shape {
  int B, HW, C;
  int sc;    // channels of a slice (whole groups)
  int cg;    // channels of a group
  int gs;    // groups of a slice
  int K;     // blocks of a cluster
  int rows;  // rows of x a block handles: ceil(HW / K)
  float inv_n, eps;
};

struct Quant {
  float inv_d, zp, nb, pb, off;
  bool int_zp;         // zp an integer below 2^20: the code by MAGIC
  float zp_off, lo, hi;  // zp - off, MAGIC + nb - off, MAGIC + pb - off
};

__device__ __forceinline__ Quant quant_args(const float* delta,
                                            const float* zp, int nb, int pb,
                                            int off) {
  Quant q;
  q.inv_d = 1.0f / delta[0];
  q.zp = zp[0];
  q.nb = (float)nb;
  q.pb = (float)pb;
  q.off = (float)off;
  q.int_zp = q.zp == rintf(q.zp) && fabsf(q.zp) <= 1048576.0f;
  q.zp_off = q.zp - (float)off;
  q.lo = MAGIC + (float)(nb - off);
  q.hi = MAGIC + (float)(pb - off);
  return q;
}

// 1 / d for d >= 1: rcp.approx refined by one Newton step, which is the
// correctly rounded reciprocal (1.0f / d, __frcp_rn) for every d in
// [1, 2^126) (tfmq_gn_check_rcp counts the floats where it is not; the card
// tests hold that count at 0), without the IEEE division's slow-path
// branch, which keeps the compiler from interleaving the codes. Above
// 2^126 (y < -87.3), where 1 / d is subnormal or 0, it returns 0: y * 0
// and y * (1 / d) are then both below 2^-119 and give the same code for
// any delta above 2^-118.
__device__ __forceinline__ float rcp_ge1(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  const float e = __fmaf_rn(-d, r, 1.0f);
  return d < 0x1p126f ? __fmaf_rn(r, e, r) : 0.0f;
}

// One code, in the low byte of the word returned. t = y / delta + MAGIC
// holds MAGIC + rint(y / delta) exactly (round half to even, as rintf)
// while |y / delta| < 2^22, and stays at least 2^21 - 2 beyond the clip
// bounds when it is larger (NaN and inf too). With an integer zp (INT_ZP),
// t + (zp - off) is then MAGIC + rint(y / delta) + zp - off exactly, and
// clipped to MAGIC + [nb, pb] - off it carries clip(rint + zp) - off in
// its low byte: rintf's code. Otherwise the code is taken as written,
// (int)(clip(rint + zp, nb, pb) - off).
template <bool SWISH, bool INT_ZP>
__device__ __forceinline__ uint32_t gn_code(float v, float a, float bb,
                                            const Quant& q) {
  float y = __fadd_rn(__fmul_rn(v, a), bb);
  if (SWISH) y = __fmul_rn(y, rcp_ge1(__fadd_rn(1.0f, expf(-y))));
  const float t = __fadd_rn(__fmul_rn(y, q.inv_d), MAGIC);
  if (INT_ZP)
    return __float_as_uint(fminf(fmaxf(__fadd_rn(t, q.zp_off), q.lo), q.hi));
  const float r =
      fminf(fmaxf(__fadd_rn(__fsub_rn(t, MAGIC), q.zp), q.nb), q.pb);
  return (uint32_t)(int)__fsub_rn(r, q.off);
}

// The statistics of one slice, shared by both routes. part holds each
// lane's column sums, [2][L][sc] (s1, then s2); the lanes are folded per
// column in lane order, the columns per group in channel order, into gp
// [2][gs]; after a cluster barrier every block sums the K ranks' gp in
// rank order into stat [2][gs] (mean, inv). The caller then arrives on
// the cluster barrier once it is done with the other ranks' shared memory,
// syncs the block before reading stat, and waits on the cluster before
// it exits.
__device__ __forceinline__ void slice_stats(float* part, float* gp,
                                            float* stat, int L,
                                            const Shape& s,
                                            cg::cluster_group& cluster) {
  const int t = threadIdx.x, n = blockDim.x, sc = s.sc, gs = s.gs;
  __syncthreads();
  for (int c = t; c < sc; c += n) {
    float a1 = 0.f, a2 = 0.f;
    for (int l = 0; l < L; ++l) {
      a1 = __fadd_rn(a1, part[l * sc + c]);
      a2 = __fadd_rn(a2, part[(L + l) * sc + c]);
    }
    part[c] = a1;
    part[L * sc + c] = a2;
  }
  __syncthreads();
  for (int g = t; g < gs; g += n) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < s.cg; ++j) {
      a1 = __fadd_rn(a1, part[g * s.cg + j]);
      a2 = __fadd_rn(a2, part[L * sc + g * s.cg + j]);
    }
    gp[g] = a1;
    gp[gs + g] = a2;
  }
  cluster.sync();
  for (int g = t; g < gs; g += n) {
    float g1 = 0.f, g2 = 0.f;
    for (int r = 0; r < s.K; ++r) {
      const float* rg = cluster.map_shared_rank(gp, r);
      g1 = __fadd_rn(g1, rg[g]);
      g2 = __fadd_rn(g2, rg[gs + g]);
    }
    const float mean = __fmul_rn(g1, s.inv_n);
    const float var = fmaxf(
        __fsub_rn(__fmul_rn(g2, s.inv_n), __fmul_rn(mean, mean)), 0.f);
    stat[g] = mean;
    stat[gs + g] = __frsqrt_rn(__fadd_rn(var, s.eps));
  }
}

// a and bb of a channel of group g from its gamma, beta and, with the
// scale-shift pair, s and t
__device__ __forceinline__ void affine(const float* stat, int gs, int g,
                                       float gamma, float beta, bool ss,
                                       float s, float t, float& a,
                                       float& bb) {
  a = __fmul_rn(stat[gs + g], gamma);
  bb = __fsub_rn(beta, __fmul_rn(stat[g], a));
  if (ss) {
    const float s1p = __fadd_rn(1.f, s);
    a = __fmul_rn(a, s1p);
    bb = __fadd_rn(__fmul_rn(bb, s1p), t);
  }
}

// The codes of rows [l2, nrows) step L2 of one V-channel column from the
// slice's rows in shared memory (row stride sc), into out (row stride C)
// with V-byte stores.
template <bool SWISH, bool INT_ZP, int V, typename T>
__device__ __forceinline__ void apply_rows(const T* xs, int8_t* out,
                                           const float* a, const float* bb,
                                           int l2, int L2, int nrows, int sc,
                                           int C, const Quant& q) {
  for (int r = l2; r < nrows; r += L2) {
    float v[V];
    load_vals<V>(xs + (size_t)r * sc, v);
    uint32_t w[V];
#pragma unroll
    for (int e = 0; e < V; ++e) w[e] = gn_code<SWISH, INT_ZP>(v[e], a[e], bb[e], q);
    store_codes<V>(out + (size_t)r * C, w);
  }
}

// The resident route, copying x in CB-byte chunks of V = CB / sizeof(T)
// channels (16 where the slice's rows allow, else 8 or 4). grid (S * K,
// B), cluster (K, 1, 1), THREADS threads; dynamic shared memory: x
// [rows][sc] of T, part [2][L][sc], prm [4][sc] (gamma, beta, s, t of the
// slice), gp [2][gs], stat [2][gs] (f32), L = LOADERS / (sc / V) lanes.
// Every thread applies a V-channel column.
template <typename T, int CB>
__global__ void __launch_bounds__(THREADS, 1)
gn_resident_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const T* __restrict__ ss_s,
                   const T* __restrict__ ss_t, const float* __restrict__ delta,
                   const float* __restrict__ zp, float* __restrict__ zp_c,
                   int8_t* __restrict__ out, Shape s, int nb, int pb, int off,
                   int swish) {
  constexpr int V = CB / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.y;
  const int slice = blockIdx.x / s.K, r0 = rank * s.rows;
  const int nrows = max(0, min(s.HW, r0 + s.rows) - r0);
  const int sc = s.sc, gs = s.gs, Q = sc / V, L = LOADERS / Q;
  T* xs = reinterpret_cast<T*>(smem);
  float* part =
      reinterpret_cast<float*>(smem + (size_t)s.rows * sc * sizeof(T));
  float* prm = part + 2 * L * sc;
  float* gp = prm + 4 * sc;
  float* stat = gp + 2 * gs;
  const int t = threadIdx.x;
  const T* xb = x + ((size_t)b * s.HW + r0) * s.C + (size_t)slice * sc;
  if (t >= L * Q) {  // the others fetch the slice's affine parameters
    for (int cs = t - L * Q; cs < sc; cs += THREADS - L * Q) {
      const int c = slice * sc + cs;
      prm[cs] = gamma[c];
      prm[sc + cs] = beta[c];
      if (ss_s != nullptr) {
        prm[2 * sc + cs] = ld(ss_s, (size_t)b * s.C + c);
        prm[3 * sc + cs] = ld(ss_t, (size_t)b * s.C + c);
      }
    }
  } else {  // a loader: column chunk q, rows l, l + L, ...
    const int q = t % Q, l = t / Q;
    const int mine = l < nrows ? (nrows - l + L - 1) / L : 0;
    for (int k = 0; k < IN_FLIGHT; ++k) {  // every copy in flight at once
      for (int i = k * mine / IN_FLIGHT; i < (k + 1) * mine / IN_FLIGHT;
           ++i) {
        const int r = l + i * L;
        cp_async<CB>(xs + (size_t)r * sc + q * V,
                     xb + (size_t)r * s.C + q * V);
      }
      cp_async_commit();
    }
    float s1[V], s2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
    for (int k = 0; k < IN_FLIGHT; ++k) {  // sum its own copies as they land
      cp_async_wait(IN_FLIGHT - 1 - k);
      for (int i = k * mine / IN_FLIGHT; i < (k + 1) * mine / IN_FLIGHT;
           ++i) {
        float v[V];
        load_vals<V>(xs + (size_t)(l + i * L) * sc + q * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] = __fadd_rn(s1[j], v[j]);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(v[j], v[j]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[l * sc + q * V + j] = s1[j];
      part[(L + l) * sc + q * V + j] = s2[j];
    }
  }
  const Quant qa = quant_args(delta, zp, nb, pb, off);
  if (blockIdx.x == 0 && b == 0 && t == 0) zp_c[0] = __fsub_rn(qa.zp, qa.off);
  // (its first block barrier also makes every loader's copies visible)
  slice_stats(part, gp, stat, L, s, cluster);
  cluster_arrive();  // done with the other ranks' shared memory
  __syncthreads();
  const int L2 = THREADS / Q;
  if (t < L2 * Q) {
    const int l2 = t / Q, cs = (t % Q) * V, c = slice * sc + cs;
    float a[V], bb[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      affine(stat, gs, (cs + j) / s.cg, prm[cs + j], prm[sc + cs + j],
             ss_s != nullptr, prm[2 * sc + cs + j], prm[3 * sc + cs + j],
             a[j], bb[j]);
    const T* xc = xs + cs;
    int8_t* ob = out + ((size_t)b * s.HW + r0) * s.C + c;
    if (swish) {
      if (qa.int_zp)
        apply_rows<true, true, V>(xc, ob, a, bb, l2, L2, nrows, sc, s.C, qa);
      else
        apply_rows<true, false, V>(xc, ob, a, bb, l2, L2, nrows, sc, s.C,
                                   qa);
    } else {
      if (qa.int_zp)
        apply_rows<false, true, V>(xc, ob, a, bb, l2, L2, nrows, sc, s.C,
                                   qa);
      else
        apply_rows<false, false, V>(xc, ob, a, bb, l2, L2, nrows, sc, s.C,
                                    qa);
    }
  }
  cluster_wait();
}

// The stream route's statistics. grid (S * K, B), cluster (K, 1, 1),
// STATS_THREADS threads; dynamic shared memory part [2][L][sc], gp
// [2][gs], stat [2][gs], L = max(1, STATS_THREADS / (sc / V)). Rank 0 of
// each cluster writes a (ab[0]) and bb (ab[1]), (2, B, C), of its slice.
template <typename T, int V>
__global__ void __launch_bounds__(STATS_THREADS, 1)
gn_stream_stats(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ ss_s,
                const T* __restrict__ ss_t, const float* __restrict__ zp,
                float* __restrict__ zp_c, float* __restrict__ ab, Shape s,
                int off) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.y;
  const int slice = blockIdx.x / s.K, r0 = rank * s.rows;
  const int nrows = max(0, min(s.HW, r0 + s.rows) - r0);
  const int sc = s.sc, gs = s.gs, Q = sc / V;
  const int L = max(1, STATS_THREADS / Q);
  float* part = reinterpret_cast<float*>(smem);
  float* gp = part + 2 * L * sc;
  float* stat = gp + 2 * gs;
  const int t = threadIdx.x, l = t / Q;
  const T* xb = x + ((size_t)b * s.HW + r0) * s.C + (size_t)slice * sc;
  if (t < L * Q) {
    for (int q = t % Q; q < Q; q += STATS_THREADS) {
      float s1[V], s2[V];
#pragma unroll
      for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll 4
      for (int r = l; r < nrows; r += L) {
        float v[V];
        load_vals<V>(xb + (size_t)r * s.C + q * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] = __fadd_rn(s1[j], v[j]);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(v[j], v[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        part[l * sc + q * V + j] = s1[j];
        part[(L + l) * sc + q * V + j] = s2[j];
      }
    }
  }
  slice_stats(part, gp, stat, L, s, cluster);
  cluster_arrive();
  __syncthreads();
  if (rank == 0) {
    for (int cs = t; cs < sc; cs += STATS_THREADS) {
      const int c = slice * sc + cs;
      const bool ss = ss_s != nullptr;
      float a, bb;
      affine(stat, gs, cs / s.cg, gamma[c], beta[c], ss,
             ss ? ld(ss_s, (size_t)b * s.C + c) : 0.f,
             ss ? ld(ss_t, (size_t)b * s.C + c) : 0.f, a, bb);
      ab[(size_t)b * s.C + c] = a;
      ab[(size_t)(s.B + b) * s.C + c] = bb;
    }
  }
  if (blockIdx.x == 0 && b == 0 && t == 0)
    zp_c[0] = __fsub_rn(zp[0], (float)off);
  cluster_wait();
}

// The stream route's apply: a grid-stride pass over the codes, 16 of one
// row a thread with 32-bit index math (C a multiple of 16; the entry
// point keeps B * HW * C / 16 below 2^31), else one.
template <bool SWISH, bool INT_ZP, typename T>
__device__ __forceinline__ void apply_flat(const T* __restrict__ x,
                                           const float* __restrict__ ab,
                                           int8_t* __restrict__ out, int B,
                                           int HW, int C, const Quant& q) {
  const size_t total = (size_t)B * HW * C;
  const int stride = gridDim.x * APPLY_THREADS;
  const int first = blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (C % 16 == 0) {
    constexpr int V = 16 / sizeof(T);
    const int Q16 = C / 16, n16 = (int)(total / 16);
    for (int i = first; i < n16; i += stride) {
      const int row = i / Q16, c = (i - row * Q16) * 16, b = row / HW;
      const float4* a4 =
          reinterpret_cast<const float4*>(ab + (size_t)b * C + c);
      const float4* b4 =
          reinterpret_cast<const float4*>(ab + (size_t)(B + b) * C + c);
      float v[16], a[16], bb[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 fa = a4[k], fb = b4[k];
        a[4 * k] = fa.x; a[4 * k + 1] = fa.y; a[4 * k + 2] = fa.z;
        a[4 * k + 3] = fa.w;
        bb[4 * k] = fb.x; bb[4 * k + 1] = fb.y; bb[4 * k + 2] = fb.z;
        bb[4 * k + 3] = fb.w;
      }
#pragma unroll
      for (int k = 0; k < 16 / V; ++k)
        load_vals<V>(x + (size_t)i * 16 + k * V, v + k * V);
      uint32_t w[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) w[e] = gn_code<SWISH, INT_ZP>(v[e], a[e], bb[e], q);
      *reinterpret_cast<uint4*>(out + (size_t)i * 16) =
          make_uint4(pack4(w), pack4(w + 4), pack4(w + 8), pack4(w + 12));
    }
  } else {
    for (size_t e = first; e < total; e += stride) {
      const int b = (int)(e / ((size_t)HW * C)), c = (int)(e % C);
      out[e] = (int8_t)gn_code<SWISH, INT_ZP>(
          ld(x, e), ab[(size_t)b * C + c], ab[(size_t)(B + b) * C + c], q);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
gn_apply(const T* __restrict__ x, const float* __restrict__ ab,
         const float* __restrict__ delta, const float* __restrict__ zp,
         int8_t* __restrict__ out, int B, int HW, int C, int nb, int pb,
         int off, int swish) {
  const Quant q = quant_args(delta, zp, nb, pb, off);
  if (swish) {
    if (q.int_zp) apply_flat<true, true>(x, ab, out, B, HW, C, q);
    else apply_flat<true, false>(x, ab, out, B, HW, C, q);
  } else {
    if (q.int_zp) apply_flat<false, true>(x, ab, out, B, HW, C, q);
    else apply_flat<false, false>(x, ab, out, B, HW, C, q);
  }
}

// Shared memory of a route's statistics block, in bytes (ops/gn_kernels.py
// gn_smem repeats it).
size_t resident_smem(const Shape& s, int item, int cb) {
  const int L = LOADERS / (s.sc * item / cb);
  return (size_t)s.rows * s.sc * item +
         4 * ((2 * (size_t)L + 4) * s.sc + 4 * (size_t)s.gs);
}

size_t stream_smem(const Shape& s, int V) {
  const int L = STATS_THREADS / (s.sc / V) > 1 ? STATS_THREADS / (s.sc / V)
                                               : 1;
  return 4 * (2 * (size_t)L * s.sc + 4 * (size_t)s.gs);
}

// Launch config for a cluster kernel; returns NO_CLUSTER_FITS where the
// occupancy query finds no room for one cluster (cached per kernel,
// device, cluster size and shared memory).
struct FitCache {
  std::mutex lock;
  struct Entry { const void* fn; int dev, k; size_t smem; int fits; };
  Entry e[64];
  int n = 0;
};

template <typename F>
int cluster_config(F* kernel, SmemAttr& attr, dim3 grid, int threads,
                   size_t smem, int K, cudaStream_t st,
                   cudaLaunchConfig_t& cfg, cudaLaunchAttribute* la) {
  int err = raise_smem(kernel, attr, (int)smem);
  if (err != 0) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = K;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  static FitCache cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> guard(cache.lock);
  for (int i = 0; i < cache.n; ++i) {
    const FitCache::Entry& c = cache.e[i];
    if (c.fn == (const void*)kernel && c.dev == dev && c.k == K &&
        c.smem == smem)
      return c.fits ? 0 : NO_CLUSTER_FITS;
  }
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (cache.n < 64) cache.e[cache.n++] = {(const void*)kernel, dev, K, smem,
                                          clusters > 0};
  return clusters > 0 ? 0 : NO_CLUSTER_FITS;
}

// the shared-memory limit raised for gn_resident_kernel<T, CB>, one record
// for every caller (a second record could lower it)
template <typename T, int CB>
SmemAttr& resident_attr() {
  static SmemAttr attr;
  return attr;
}

template <typename T, int CB>
int launch_resident(const T* x, const float* gamma, const float* beta,
                    const T* ss_s, const T* ss_t, const float* delta,
                    const float* zp, float* zp_c, int8_t* out, Shape s,
                    dim3 grid, int nb, int pb, int off, int swish,
                    cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute la[1];
  int err = cluster_config(gn_resident_kernel<T, CB>, resident_attr<T, CB>(),
                           grid, THREADS,
                           resident_smem(s, (int)sizeof(T), CB), s.K, st,
                           cfg, la);
  if (err != 0) return err;
  return (int)cudaLaunchKernelEx(&cfg, gn_resident_kernel<T, CB>, x, gamma,
                                 beta, ss_s, ss_t, delta, zp, zp_c, out, s,
                                 nb, pb, off, swish);
}

template <typename T>
int launch(const T* x, const float* gamma, const float* beta, const T* ss_s,
           const T* ss_t, const float* delta, const float* zp, float* zp_c,
           float* ab, int8_t* out, Shape s, int route, int S, int nb, int pb,
           int off, int swish, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute la[1];
  const dim3 grid(S * s.K, s.B);
  if (route == 0) {
    const int row = s.sc * (int)sizeof(T);
    if (row % 16 == 0)
      return launch_resident<T, 16>(x, gamma, beta, ss_s, ss_t, delta, zp,
                                    zp_c, out, s, grid, nb, pb, off, swish,
                                    st);
    if (row % 8 == 0)
      return launch_resident<T, 8>(x, gamma, beta, ss_s, ss_t, delta, zp,
                                   zp_c, out, s, grid, nb, pb, off, swish,
                                   st);
    return launch_resident<T, 4>(x, gamma, beta, ss_s, ss_t, delta, zp,
                                 zp_c, out, s, grid, nb, pb, off, swish, st);
  }
  constexpr int VEC = 16 / sizeof(T);
  int err;
  if ((s.sc * sizeof(T)) % 16 == 0) {  // 16-byte loads of the slice's rows
    static SmemAttr attr;
    err = cluster_config(gn_stream_stats<T, VEC>, attr, grid, STATS_THREADS,
                         stream_smem(s, VEC), s.K, st, cfg, la);
    if (err == 0)
      err = (int)cudaLaunchKernelEx(&cfg, gn_stream_stats<T, VEC>, x, gamma,
                                    beta, ss_s, ss_t, zp, zp_c, ab, s, off);
  } else {
    static SmemAttr attr;
    err = cluster_config(gn_stream_stats<T, 1>, attr, grid, STATS_THREADS,
                         stream_smem(s, 1), s.K, st, cfg, la);
    if (err == 0)
      err = (int)cudaLaunchKernelEx(&cfg, gn_stream_stats<T, 1>, x, gamma,
                                    beta, ss_s, ss_t, zp, zp_c, ab, s, off);
  }
  if (err != 0) return err;
  const size_t total = (size_t)s.B * s.HW * s.C;
  const size_t work = s.C % 16 == 0 ? total / 16 : total;
  const size_t blocks = (work + APPLY_THREADS - 1) / APPLY_THREADS;
  gn_apply<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), APPLY_THREADS, 0,
                st>>>(x, ab, delta, zp, out, s.B, s.HW, s.C, nb, pb, off,
                      swish);
  return (int)cudaGetLastError();
}

// Counts the floats d in [1, 2^126) where rcp_ge1(d) differs from
// __frcp_rn(d) or from 1.0f / d.
__global__ void rcp_check_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  const uint32_t lo = 0x3f800000u, hi = 0x7e800000u;  // 1, 2^126
  for (uint32_t u = lo + blockIdx.x * blockDim.x + threadIdx.x; u < hi;
       u += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(u);
    const uint32_t r = __float_as_uint(rcp_ge1(d));
    n += (r != __float_as_uint(__frcp_rn(d))) + (r != __float_as_uint(1.0f / d));
  }
  atomicAdd(bad, n);
}

}  // namespace

extern "C" {

// out: how many clusters of k resident blocks (bf16, 16-byte copies) with
// smem bytes of shared memory each the card runs at once
// (cudaOccupancyMaxActiveClusters; ops/gn_kernels.py CLUSTER_SLOTS).
int tfmq_gn_cluster_slots(int k, int smem, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto* kernel = gn_resident_kernel<__nv_bfloat16, 16>;
  int err = raise_smem(kernel, resident_attr<__nv_bfloat16, 16>(), smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute la[1];
  cfg.gridDim = dim3(k);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = k;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// bad: one zeroed u64 on the device; adds the count of rcp_ge1's
// mismatches (each float counted once against __frcp_rn, once against
// 1.0f / d).
int tfmq_gn_check_rcp(void* bad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rcp_check_kernel<<<1056, 512, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)bad);
  return (int)cudaGetLastError();
}


// x (B, HW, C) f32 (x_bf16 = 0) or bf16 (1), 16-byte aligned; gamma, beta
// (C,) f32; ss_s, ss_t (B, C) of x's type, or both null; delta, zp (1,)
// f32 on the device; zp_c (1,) f32 out; out (B, HW, C) int8. The plan:
// route 0 (resident: slices of rows a multiple of 4 bytes, at most
// LOADERS copies of 16, 8 or 4 bytes) or 1 (stream; ab (2, B, C) f32
// scratch),
// slices of C (each whole groups), cluster blocks (1 to 8). Launches on
// the given stream (PyTorch's current stream) and returns 0, a
// cudaError_t, or NO_CLUSTER_FITS (100000).
int tfmq_gn_swish_quant(const void* x, int x_bf16, const void* gamma,
                        const void* beta, const void* ss_s, const void* ss_t,
                        const void* delta, const void* zp, void* zp_c,
                        void* ab, void* out, int B, int HW, int C, int groups,
                        int route, int slices, int cluster, float inv_n,
                        float eps, int nb, int pb, int off, int swish,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int item = x_bf16 ? 2 : 4;
  if (B < 1 || HW < 1 || C < 1 || groups < 1 || C % groups != 0 ||
      slices < 1 || groups % slices != 0 || cluster < 1 || cluster > 8 ||
      (route != 0 && route != 1) || (uintptr_t)x % 16 != 0 ||
      (size_t)B * HW * C / 16 >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.B = B;
  s.HW = HW;
  s.C = C;
  s.sc = C / slices;
  s.cg = C / groups;
  s.gs = s.sc / s.cg;
  s.K = cluster;
  s.rows = (HW + cluster - 1) / cluster;
  s.inv_n = inv_n;
  s.eps = eps;
  const int row = s.sc * item, cb = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : 4;
  if (route == 0 && (row % 4 != 0 || row / cb > LOADERS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return launch<__nv_bfloat16>(
        (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
        (const __nv_bfloat16*)ss_s, (const __nv_bfloat16*)ss_t,
        (const float*)delta, (const float*)zp, (float*)zp_c, (float*)ab,
        (int8_t*)out, s, route, slices, nb, pb, off, swish, st);
  return launch<float>((const float*)x, (const float*)gamma,
                       (const float*)beta, (const float*)ss_s,
                       (const float*)ss_t, (const float*)delta,
                       (const float*)zp, (float*)zp_c, (float*)ab,
                       (int8_t*)out, s, route, slices, nb, pb, off, swish,
                       st);
}

}  // extern "C"
