"""Exact int8 GEMM: the port's counterpart of ``int8_matmul_pre`` in
``tfmq_dm_tpu/ops/pallas_kernels.py`` (``_int8_mm_pre_kernel``), and the
int32 products the JAX package leaves to XLA.

- ``int8_matmul_pre``  centered int8 codes x (M, K) @ w (K, N), int32
  sums on the tensor cores, then the zero-point corrections, the dequant
  scale and the bias fused in the epilogue (f32 or bf16 out);
- ``int8_matmul_fused``  the same from f32 or bf16 x, quantized per
  tensor inside the kernel (``int8_matmul_fused`` / ``_int8_mm_kernel``):
  by construction equal to ``int_ops.quantize_act_int8`` followed by
  ``int8_matmul_pre``, bit for bit;
- ``int8_conv_acc``    the int32 accumulator of a conv on zero-padded
  codes: an im2col of the codes (K padded with zero codes to a multiple
  of 16) through the same kernel;
- ``int8_bmm_acc``     batched int32 products of codes (the attention
  products above the f32-exact bound).

The kernel is CUDA C++ for ``sm_90a`` (``csrc/int8_kernels.cu``), built
with ``nvcc`` into ``_build/`` at first use and called through a plain C
interface with ``ctypes``. It takes the weight codes K-major, w^T (N, Kp)
with K zero-padded to a multiple of 16 (``kmajor``): the deployed weight
record carries that copy (``int_ops.IntWeight.w_t``), made once at deploy.
The public functions keep the JAX layout w_q (K, N) and take the copy as
``w_t``; a call on the card without it makes one itself and counts it in
``KMAJOR_COPIES`` (the deployed path makes none). Each wrapper dispatches
on its input's device: a CPU tensor takes the plain PyTorch version beside
it (the tests use it); a CUDA tensor launches the kernel, or raises. The
plain versions sum the codes in float64, which is exact for these sums
(|x w| <= 2^14, K < 2^39), so kernel and plain agree bit for bit on the
accumulators and, with the epilogue evaluated in the same order, on the
outputs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary, check, launch_check, ptr

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "int8_kernels.cu"

# launches of each wrapper since the last reset (chip_smoke.py reads these)
LAUNCHES = {"int8_matmul_pre": 0, "int8_matmul_fused": 0, "int8_conv2d": 0,
            "int8_bmm": 0}
# K-major weight copies made by a call on the card that came without one
KMAJOR_COPIES = {"int8_matmul_pre": 0, "int8_matmul_fused": 0,
                 "int8_conv2d": 0, "int8_bmm": 0}

_MODES = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tfmq_int8_gemm.argtypes = [p] * 10 + [i] * 12 + [p]
    lib.tfmq_int8_gemm.restype = i
    lib.tfmq_int8_gemm_fused.argtypes = [p, i] + [p] * 7 + [i] * 10 + [p]
    lib.tfmq_int8_gemm_fused.restype = i


LIBRARY = CudaLibrary(SOURCE, _bind)
BUILD_LOG = LIBRARY.log


def build(force: bool = False):
    """Compile ``csrc/int8_kernels.cu`` (once per source content) and load
    it. ``force`` removes its built library first, for a cold build."""
    return LIBRARY.load(force)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, KMAJOR_COPIES):
        for k in counts:
            counts[k] = 0


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


# K bytes of a step of the K split (a wgmma pipeline stage; two of the
# mma.sync route's)
GEMM_KB = 128
# the card's streaming multiprocessors (H100 SXM), for the tile plan
GEMM_SMS = 132
# K from which the GEMM takes the wgmma route (measured on an H100, PERF.md
# section 6: wgmma's 128-row tiles win from K 1728 on, mma.sync below 1536)
WGMMA_MIN_K = 1600


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, n: int, k: int, batch: int = 1,
              sms: int = GEMM_SMS):
    """(route, bm, bn, split, kchunk) of the int8 GEMM for an (M, K) x
    (K, N) product. Long K (>= ``WGMMA_MIN_K``) takes "wgmma": 128 rows
    (two warpgroups) by 192 columns where N is 192 or a multiple of 192
    that still fills the card, else by 128. Short K takes "mma"
    (mma.sync): 128 x 128 tiles where they fill the card twice, else
    64 x 128. A single product whose tiles fill under half of the
    ``sms`` splits K into ranges of ``kchunk`` bytes (a multiple of 128,
    at least two steps each, at most 16 ranges)."""
    def tiles(bm, bn):
        return _ceil(m, bm) * _ceil(n, bn) * batch

    if k >= WGMMA_MIN_K:
        route, bm = "wgmma", 128
        bn = 192 if n % 192 == 0 and (n == 192 or tiles(128, 192) >= sms) \
            else 128
    else:
        route, bn = "mma", 128
        bm = 128 if tiles(128, 128) >= 2 * sms else 64
    steps = _ceil(k, GEMM_KB)
    split = 1
    if batch == 1 and 2 * tiles(bm, bn) < sms and steps >= 4:
        split = min(_ceil(sms, tiles(bm, bn)), steps // 2, 16)
    kchunk = _ceil(steps, split) * GEMM_KB
    return route, bm, bn, _ceil(k, kchunk), kchunk


# K bytes of a stage of the fused GEMM's A panel; panels of 128 rows up
# to this K (two blocks an SM), of 64 rows above
FUSED_KB = 64
FUSED_PANEL128_K = 768
FUSED_BN = 128
# shared memory of an SM a block may take (H100: 227 KB)
SMEM_PER_SM = 232448


def fused_smem(route: str, bm: int, k: int) -> int:
    """Shared-memory bytes of a block of the fused GEMM: the A panel (all
    of K for "panel", a four-stage ring for "stream"), the weights' ring
    and the row sums."""
    stages = 4 if route == "stream" else _ceil(k, FUSED_KB)
    return (stages * bm + 4 * FUSED_BN) * FUSED_KB + 4 * bm


def fused_groups(route: str, bm: int, m: int, n: int, k: int,
                 sms: int = GEMM_SMS) -> int:
    """The groups of 128-wide N tiles of the fused GEMM: "panel" cuts them
    so that the blocks fill the card (two an SM where two fit); "stream"
    gives each block one tile (its x is quantized once a tile anyway)."""
    ntiles = _ceil(n, FUSED_BN)
    if route == "stream":
        return ntiles
    per_sm = 2 if 2 * fused_smem(route, bm, k) <= SMEM_PER_SM else 1
    groups = min(ntiles, max(1, _ceil(per_sm * sms, _ceil(m, bm))))
    return _ceil(ntiles, _ceil(ntiles, groups))


def fused_plan(m: int, n: int, k: int, sms: int = GEMM_SMS):
    """(route, bm, bn, groups) of ``int8_matmul_fused``, from a sweep of
    every route and panel height on an H100 (PERF.md section 6). The
    panel has 128 rows up to K ``FUSED_PANEL128_K`` where its blocks
    still cover the card's SMs, else 64. "panel" (a block quantizes its
    panel once and walks a group of 128-wide N tiles against it) where
    the panel fits in shared memory beside the weight ring and pays: a
    group holds more than one N tile, or the blocks run in one wave.
    Otherwise "stream" (the panel's stages quantized as they are
    loaded), 128 rows where its tiles fill the card twice, else 64.
    Groups from ``fused_groups``."""
    kp = _ceil(k, FUSED_KB) * FUSED_KB
    ntiles = _ceil(n, FUSED_BN)
    bm = 128 if kp <= FUSED_PANEL128_K and _ceil(m, 128) * fused_groups(
        "panel", 128, m, n, k, sms) >= sms else 64
    smem = fused_smem("panel", bm, k)
    if smem <= SMEM_PER_SM:
        groups = fused_groups("panel", bm, m, n, k, sms)
        per_sm = 2 if 2 * smem <= SMEM_PER_SM else 1
        if groups < ntiles or _ceil(m, bm) * groups <= per_sm * sms:
            return "panel", bm, FUSED_BN, groups
    bm = 128 if _ceil(m, 128) * ntiles >= 2 * sms else 64
    return "stream", bm, FUSED_BN, fused_groups("stream", bm, m, n, k, sms)


def kmajor(w_q: torch.Tensor, align: int = 16) -> torch.Tensor:
    """The kernel's weight layout: codes w_q (..., N) (HWIO for a conv,
    flattened to (K, N) in (kh, kw, Cin) order) as w^T (N, Kp), K-major,
    zero-padded to Kp = K rounded up to ``align``."""
    n = w_q.shape[-1]
    w2 = w_q.reshape(-1, n)
    k = w2.shape[0]
    out = torch.zeros((n, _ceil(k, align) * align), dtype=torch.int8,
                      device=w_q.device)
    out[:, :k] = w2.t()
    return out


def _weight_t(name: str, w_q: torch.Tensor,
              w_t: Optional[torch.Tensor]) -> torch.Tensor:
    """The K-major copy a call on the card uses: ``w_t``, or one made now
    (counted in ``KMAJOR_COPIES``)."""
    if w_t is not None:
        return w_t
    KMAJOR_COPIES[name] += 1
    return kmajor(w_q)


def _launch(name, x, w_t, m, k, n, batch, out_dtype, xsum=None, delta=None,
            zp_c=None, wsum=None, bias=None, sc=None) -> torch.Tensor:
    """x (batch, M, K) codes @ w_t (batch, N, Kp)^T on the kernel: int32
    (``out_dtype`` None) or the epilogue as f32 / bf16, on the route and
    tile of ``gemm_plan``."""
    dev = x.device
    kp = w_t.shape[-1]
    if kp < k or kp % 16:
        raise ValueError(f"{name}: K-major weights of width {kp} for K {k} "
                         "(needs >= K, a multiple of 16)")
    check("x", x, torch.int8, (batch, m, k) if batch > 1 else (m, k), dev)
    check("w_t", w_t, torch.int8, (batch, n, kp) if batch > 1 else (n, kp),
          dev)
    shape = (batch, m, n) if batch > 1 else (m, n)
    if out_dtype is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        check("xsum", xsum, torch.float32, (m, 1), dev)
        for nm, t in (("delta", delta), ("zp_c", zp_c), ("wsum", wsum)):
            check(nm, t, torch.float32, (n,), dev)
        if bias is not None:
            check("bias", bias, torch.float32, (n,), dev)
        check("sc", sc, torch.float32, (2,), dev)
        out = torch.empty(shape, dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError(f"{name}: K = 0")
    route, bm, bn, split, kchunk = gemm_plan(m, n, k, batch)
    ws = None if split == 1 else torch.empty((split, m, n),
                                             dtype=torch.int32, device=dev)
    lib = build()
    err = lib.tfmq_int8_gemm(ptr(x), ptr(w_t), ptr(xsum), ptr(delta),
                             ptr(zp_c), ptr(wsum), ptr(bias), ptr(sc),
                             ptr(out), ptr(ws), m, k, n, kp, batch,
                             _MODES[out_dtype], bm, bn, split, kchunk,
                             int(route == "wgmma"), dev.index or 0,
                             torch.cuda.current_stream(dev).cuda_stream)
    launch_check(name, err)
    LAUNCHES[name] += 1
    return out


def _acc_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 codes, through float64."""
    return (x.double() @ w.double()).to(torch.int32)


# ---------------------------------------------------------------------------
# int8_matmul_pre
# ---------------------------------------------------------------------------

def _scalars(dx, zp_xc, dev) -> torch.Tensor:
    return torch.stack([torch.as_tensor(a, dtype=torch.float32,
                                        device=dev).reshape(())
                        for a in (dx, zp_xc)])


def int8_matmul_pre_plain(x_q, xsum, w_q, delta_w, zp_wc, wsum, dx, zp_xc,
                          bias=None, out_dtype=torch.float32, w_t=None):
    """The kernel's arithmetic in PyTorch ops: the exact int32 product,
    then the epilogue of ``_int8_mm_pre_kernel`` in its order (``w_t``,
    the kernel's weight layout, is not read)."""
    k = x_q.shape[1]
    acc = _acc_plain(x_q, w_q).float()
    corr = acc - zp_wc * xsum
    corr = corr - zp_xc * wsum
    corr = corr + (k * zp_xc) * zp_wc
    out = (dx * delta_w) * corr
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def int8_matmul_pre(x_q: torch.Tensor, xsum: torch.Tensor,
                    w_q: torch.Tensor, delta_w: torch.Tensor,
                    zp_wc: torch.Tensor, wsum: torch.Tensor, dx, zp_xc,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype=torch.float32,
                    w_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_q (M, K) centered int8 codes, xsum (M, 1) f32 row sums of x_q,
    w_q (K, N) centered int8, per-channel delta_w / zp_wc / wsum (N,) f32,
    scalar act grid (dx, zp_xc), optional f32 bias (N,) ->
    dx dw (x_q w_q - zp_wc xsum - zp_xc wsum + K zp_xc zp_wc) + b as
    ``out_dtype`` (f32 or bf16). ``w_t``: w_q's K-major copy
    (``kmajor(w_q)``), which the kernel reads."""
    if not _on_cuda("int8_matmul_pre", x_q):
        return int8_matmul_pre_plain(x_q, xsum, w_q, delta_w, zp_wc, wsum,
                                     dx, zp_xc, bias, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul_pre: out_dtype {out_dtype}")
    m, k = x_q.shape
    n = w_q.shape[1]
    return _launch("int8_matmul_pre", x_q,
                   _weight_t("int8_matmul_pre", w_q, w_t), m, k, n, 1,
                   out_dtype, xsum, delta_w, zp_wc, wsum, bias,
                   _scalars(dx, zp_xc, x_q.device))


# ---------------------------------------------------------------------------
# int8_matmul_fused
# ---------------------------------------------------------------------------

def int8_matmul_fused_plain(x, w_q, delta_w, zp_wc, wsum, dx, zp_xc,
                            bias=None, out_dtype=torch.float32, w_t=None):
    """The kernel's arithmetic in PyTorch ops: ``_int8_mm_kernel``'s
    quantization, clip(round(x (1/dx)) + zp_xc + 128, 0, 255) - 128 with
    1/dx rounded once to f32, the codes' row sums over K, then
    ``int8_matmul_pre_plain`` (``w_t``, the kernel's weight layout, is not
    read)."""
    dx = torch.as_tensor(dx, dtype=torch.float32, device=x.device)
    zp_xc = torch.as_tensor(zp_xc, dtype=torch.float32, device=x.device)
    x_q = (torch.clamp(torch.round(x.float() * (1.0 / dx)) + (zp_xc + 128.0),
                       0.0, 255.0) - 128.0).to(torch.int8)
    xsum = x_q.to(torch.int32).sum(-1, keepdim=True).float()
    return int8_matmul_pre_plain(x_q, xsum, w_q, delta_w, zp_wc, wsum, dx,
                                 zp_xc, bias, out_dtype)


def int8_matmul_fused(x: torch.Tensor, w_q: torch.Tensor,
                      delta_w: torch.Tensor, zp_wc: torch.Tensor,
                      wsum: torch.Tensor, dx, zp_xc,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype=torch.float32,
                      w_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) f32 or bf16, quantized per tensor to centered int8 codes
    with the 8-bit grid (dx, zp_xc + 128) inside the kernel; then as
    ``int8_matmul_pre``: w_q (K, N) centered int8, per-channel delta_w /
    zp_wc / wsum (N,) f32, optional f32 bias (N,), ``out_dtype`` f32 or
    bf16. ``w_t``: w_q's K-major copy (``kmajor(w_q)``), which the kernel
    reads. The TPU block sizes are not taken: ``fused_plan`` tiles."""
    if not _on_cuda("int8_matmul_fused", x):
        return int8_matmul_fused_plain(x, w_q, delta_w, zp_wc, wsum, dx,
                                       zp_xc, bias, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul_fused: out_dtype {out_dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul_fused: x dtype {x.dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    dev = x.device
    check("x", x, x.dtype, (m, k), dev)
    check("w", w_q, torch.int8, (k, n), dev)
    for nm, t in (("delta", delta_w), ("zp_c", zp_wc), ("wsum", wsum)):
        check(nm, t, torch.float32, (n,), dev)
    if bias is not None:
        check("bias", bias, torch.float32, (n,), dev)
    w_t = _weight_t("int8_matmul_fused", w_q, w_t)
    kp = w_t.shape[-1]
    if kp < k or kp % 16:
        raise ValueError(f"int8_matmul_fused: K-major weights of width {kp} "
                         f"for K {k} (needs >= K, a multiple of 16)")
    check("w_t", w_t, torch.int8, (n, kp), dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("int8_matmul_fused: K = 0")
    sc = _scalars(dx, zp_xc, dev)
    route, bm, bn, groups = fused_plan(m, n, k)
    err = build().tfmq_int8_gemm_fused(
        ptr(x), int(x.dtype == torch.bfloat16), ptr(w_t), ptr(delta_w),
        ptr(zp_wc), ptr(wsum), ptr(bias), ptr(sc), ptr(out), m, k, n, kp,
        _MODES[out_dtype], int(route == "stream"), bm, bn, groups,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    launch_check("int8_matmul_fused", err)
    LAUNCHES["int8_matmul_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# int32 accumulators: batched products and the conv on an im2col
# ---------------------------------------------------------------------------

def int8_bmm_acc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _acc_plain(a, b)


def int8_bmm_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 a (Bt, M, K) @ b (Bt, K, N) of int8 codes, exact. On the card
    b is copied K-major (counted in ``KMAJOR_COPIES``)."""
    if not _on_cuda("int8_bmm", a):
        return int8_bmm_acc_plain(a, b)
    bt, m, k = a.shape
    n = b.shape[2]
    KMAJOR_COPIES["int8_bmm"] += 1
    b_t = torch.zeros((bt, n, _ceil(k, 16) * 16), dtype=torch.int8,
                      device=b.device)
    b_t[..., :k] = b.transpose(1, 2)
    if bt == 1:
        return _launch("int8_bmm", a[0], b_t[0], m, k, n, 1, None)[None]
    return _launch("int8_bmm", a, b_t, m, k, n, bt, None)


def conv_pads(padding, kh: int, kw: int):
    """((top, bottom), (left, right)) of "SAME" (odd kernels), "VALID" or
    explicit pads."""
    if padding == "SAME":
        return ((kh // 2, kh // 2), (kw // 2, kw // 2))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def windows(x: torch.Tensor, kh: int, kw: int, stride: int, pads):
    """Zero-pad NHWC ``x`` and view its (kh, kw) windows:
    (B, Ho, Wo, kh, kw, C), no copy of the padded tensor."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    b, hp, wp, c = xp.shape
    ho = (hp - kh) // stride + 1
    wo = (wp - kw) // stride + 1
    sb, sh, sw, sc = xp.stride()
    return xp.as_strided((b, ho, wo, kh, kw, c),
                         (sb, sh * stride, sw * stride, sh, sw, sc))


def im2col(x_q: torch.Tensor, kh: int, kw: int, stride: int, pads,
           align: int = 16) -> torch.Tensor:
    """(B*Ho*Wo, Kp) int8 columns of the zero-padded codes in (kh, kw, C)
    order (HWIO's flattening), K = kh kw C padded with zero codes to a
    multiple of ``align``."""
    win = windows(x_q, kh, kw, stride, pads)
    b, ho, wo = win.shape[:3]
    k = kh * kw * x_q.shape[3]
    kp = -(-k // align) * align
    cols = torch.zeros((b, ho, wo, kp), dtype=torch.int8,
                       device=x_q.device)
    cols[..., :k].view(win.shape).copy_(win)
    return cols.view(b * ho * wo, kp)


def _conv_shape(x_q, w_q, stride, pads):
    (pt, pb), (pl, pr) = pads
    kh, kw = w_q.shape[:2]
    return (x_q.shape[0], (x_q.shape[1] + pt + pb - kh) // stride + 1,
            (x_q.shape[2] + pl + pr - kw) // stride + 1, w_q.shape[3])


def int8_conv_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                        stride: int = 1, pads=((1, 1), (1, 1)),
                        w_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The exact int32 conv of the codes' im2col through float64 (``w_t``,
    the kernel's weight layout, is not read)."""
    kh, kw, cin, n = w_q.shape
    k = kh * kw * cin
    cols = im2col(x_q, kh, kw, stride, pads)[:, :k]
    return _acc_plain(cols, w_q.reshape(k, n)).view(
        _conv_shape(x_q, w_q, stride, pads))


def int8_conv_acc(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                  pads=((1, 1), (1, 1)),
                  w_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 conv of NHWC int8 codes with HWIO int8 codes, zero padding
    ``pads``: (B, Ho, Wo, N). On the card: the GEMM of the codes' im2col
    (K = kh kw Cin padded with zero codes to a multiple of 16) with
    ``w_t``, the K-major copy of the weights (``kmajor(w_q)``)."""
    if not _on_cuda("int8_conv2d", x_q):
        return int8_conv_acc_plain(x_q, w_q, stride, pads)
    kh, kw, cin, n = w_q.shape
    shape = _conv_shape(x_q, w_q, stride, pads)
    cols = im2col(x_q.contiguous(), kh, kw, stride, pads)
    m, kc = cols.shape
    return _launch("int8_conv2d", cols, _weight_t("int8_conv2d", w_q, w_t),
                   m, kc, n, 1, None).view(shape)
