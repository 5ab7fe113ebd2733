"""Flash-attention kernels: the port's counterpart of
``tfmq_dm_tpu/ops/flash_attention.py``.

- ``flash_fp``      replaces mode ``fp``     (``_fp_kernel``)
- ``flash_pquant``  replaces mode ``pquant`` (``_quant_kernel``)
- ``flash_int8``    replaces mode ``int8``   (``_int8_kernel``)
- ``flash_fqk``     replaces mode ``fqk``    (``_fqk_kernel``)

All four are CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), built
with ``nvcc`` into ``_build/`` at first use and called through a plain C
interface with ``ctypes``. The first three take (B*H, T, D) float32
tensors (int8 codes for ``flash_int8``), ``flash_fqk`` bf16 ones; each
dispatches on the device: a CPU tensor takes the plain PyTorch version
beside it (the tests use it); a CUDA tensor launches the kernel, or
raises. Nothing falls back from one to the other. The kernels take head
dims up to ``MAX_HEAD_DIM``; a larger one raises. ``flash_int8`` and
``flash_fqk`` launch a pre-pass kernel first (K/V or v codes into scratch
once per call); one wrapper call counts one launch.

The plain versions materialize the (T, T) scores and round where the
kernels round. The softmax quantizer's operand is the Pallas kernels' own:
over key blocks of ``block_k`` (default 2048, narrowed to Tk rounded up to
128), e = exp(s - m_b) against the running row max m_b after each block,
rebased by one row-scalar factor exp(m_b - m) / (l delta) and rounded
(flash_attention.py:134-163). The kernels recompute the scores in a
second pass instead of caching e, and keep the block maxes m_b. Kernels
and plain versions differ in the order of f32 sums only, so a quantized
probability at a rounding boundary may flip by one level.

``flash_attention`` over (B, H, T, D) mirrors the JAX entry point: mode
int8 quantizes q/k/v to centered int8 codes with their row sums outside
the kernel (``_quant_i8``), as the JAX call does; mode fqk fake-quantizes
them inside the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .cuda_build import CudaLibrary, check, launch_check, ptr

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / \
    "flash_attention.cu"
MAX_HEAD_DIM = 384
# the Pallas call's default key block (flash_attention.py:582-583), and
# the most key blocks the kernels keep row maxes for
BLOCK_K = 2048
MAX_KEY_BLOCKS = 64

# launches of each kernel since the last reset (chip_smoke.py reads these)
LAUNCHES = {"flash_fp": 0, "flash_pquant": 0, "flash_int8": 0,
            "flash_fqk": 0}


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfmq_flash_f32.argtypes = [p] * 5 + [i] * 5 + [f, i, f, f, i, i, p]
    lib.tfmq_flash_f32.restype = i
    lib.tfmq_flash_int8.argtypes = [p] * 9 + [i] * 7 + [f, i, f, f, i, p]
    lib.tfmq_flash_int8.restype = i
    lib.tfmq_int8_vt.argtypes = [p] * 2 + [i] * 6 + [p]
    lib.tfmq_int8_vt.restype = i
    lib.tfmq_flash_fqk.argtypes = [p] * 9 + [i] * 7 + [f, i, i] \
        + [f] * 8 + [i, p]
    lib.tfmq_flash_fqk.restype = i
    lib.tfmq_fqk_prepass.argtypes = [p] * 7 + [i] * 6 + [f] * 4 + [i, p]
    lib.tfmq_fqk_prepass.restype = i


LIBRARY = CudaLibrary(SOURCE, _bind)
BUILD_LOG = LIBRARY.log


def build(force: bool = False):
    """Compile ``csrc/flash_attention.cu`` (once per source content) and
    load it. ``force`` removes its built library first."""
    return LIBRARY.load(force)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _device_or_raise(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check_dims(name: str, q, k, v) -> Tuple[int, int, int, int]:
    bh, tq, d = q.shape
    tk = k.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM} is not "
                         "taken by the CUDA kernel")
    return bh, tq, tk, d


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# plain versions (materialized, the kernels' rounding points)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def key_block(tk: int, block_k: int = BLOCK_K) -> int:
    """The key block the Pallas call takes: ``block_k``, but no wider than
    Tk rounded up to 128 (flash_attention.py:591-592)."""
    return min(block_k, -(-tk // 128) * 128)


def _row_softmax_parts(s: torch.Tensor):
    """e = exp(s - rowmax), l = sum e."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e, e.sum(dim=-1, keepdim=True)


def _blocked_softmax(s: torch.Tensor, bk: int):
    """The fill pass of the Pallas kernels (flash_attention.py:134-149,
    242-253) over key blocks of ``bk`` columns: e = exp(s - m_b) against
    the running row max m_b after each block, the denominator l rescaled
    block by block, and the rebase factor exp(m_b - m) of each block's
    columns to the final max m. Returns (e, rebase, l)."""
    m = s.new_full(s.shape[:-1] + (1,), NEG_INF)
    l = s.new_zeros(s.shape[:-1] + (1,))
    es, ms = [], []
    for c0 in range(0, s.shape[-1], bk):
        sb = s[..., c0:c0 + bk]
        m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        e = torch.exp(sb - m_new)
        l = l * torch.exp(m - m_new) + e.sum(dim=-1, keepdim=True)
        m = m_new
        es.append(e)
        ms.append(m_new.expand_as(e))
    return torch.cat(es, -1), torch.exp(torch.cat(ms, -1) - m), l


def _p_round(e, rebase, inv):
    """round(e f) with f = exp(m_b - m) inv, the Pallas kernels' operand
    of the softmax quantizer (one row-scalar factor per key block)."""
    return torch.round(e * (rebase * inv))


def _p_levels(x, zp, qrange, zp_zero):
    """Quantized softmax levels (p_q - zp) of round(p / delta) = ``x``:
    clip(x + zp) - zp, or min(x, pb) for an always-zero grid."""
    nb, pb = qrange
    if zp_zero:
        return torch.clamp(x, max=pb)
    return torch.clamp(x + zp, nb, pb) - zp


def tf32_split(x: torch.Tensor):
    """The pquant kernel's operand split in PyTorch ops: x = hi + lo + r
    with hi = tf32(x) (``cvt.rna.tf32.f32``: 11 significant bits, nearest,
    ties away from zero), lo = tf32(x - hi), |r| <= 2^-22 |x|; exact for an
    integer below 2^22 in magnitude. Returns (hi, lo) as float32 tensors
    whose 13 low mantissa bits are zero."""
    def rna(t):
        u = t.float().contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x.float() - hi)


def flash_fp_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    s = (q @ k.transpose(1, 2)) * sm_scale
    e, l = _row_softmax_parts(s)
    return (e @ v) / l


def flash_pquant_plain(q, k, v, sm_scale: float, dz: torch.Tensor,
                       qrange, zp_zero: bool,
                       block_k: int = BLOCK_K) -> torch.Tensor:
    s = (q @ k.transpose(1, 2)) * sm_scale
    e, rebase, l = _blocked_softmax(s, key_block(k.shape[1], block_k))
    delta, zp = dz[0], dz[1]
    x = _p_round(e, rebase, 1.0 / (l * delta))
    return delta * (_p_levels(x, zp, qrange, zp_zero) @ v)


def _int8_scores(q8, k8, qsum, ksum, sc, sm_scale):
    """dq dk (q8.k8 - zk' sum q - zq' sum k + D zq' zk') sm_scale, in the
    Pallas kernel's order; the integer product is exact in float64."""
    d = q8.shape[-1]
    acc = (q8.double() @ k8.double().transpose(1, 2)).float()
    dq, zq, dk, zk = sc[0], sc[1], sc[2], sc[3]
    zq_c, zk_c = zq - 128.0, zk - 128.0
    x = ((acc - zk_c * qsum[:, :, None]) - zq_c * ksum[:, None, :]) \
        + (float(d) * zq_c) * zk_c
    return ((dq * dk) * x) * sm_scale


def _int8_pv(p_q, zw, v8, zv, scale) -> torch.Tensor:
    """scale * sum_j (p_q - zw)(v_q - zv) over the real keys, exact in
    float64 (v8 = v_q - 128)."""
    corr = (p_q - zw).double() @ (v8.double() - (zv.double() - 128.0))
    return scale * corr.float()


def flash_int8_plain(q8, k8, v8, qsum, ksum, vsum, sc, sm_scale: float,
                     qrange=None, block_k: int = BLOCK_K) -> torch.Tensor:
    """``qrange`` None: no softmax quantizer (p stays f32, v dequantized);
    else p levels and v codes, summed exactly."""
    s = _int8_scores(q8, k8, qsum, ksum, sc, sm_scale)
    dv, zv, dw, zw = sc[4], sc[5], sc[6], sc[7]
    if qrange is None:
        e, l = _row_softmax_parts(s)
        vdq = dv * (v8.float() - (zv - 128.0))
        return (e @ vdq) / l
    nb, pb = qrange
    e, rebase, l = _blocked_softmax(s, key_block(k8.shape[1], block_k))
    p_q = torch.clamp(_p_round(e, rebase, 1.0 / (l * dw)) + zw, nb, pb)
    return _int8_pv(p_q, zw, v8, zv, dw * dv)


def fake_quant_tile(x, delta, zp, qrange, dtype):
    """``_fq``: f32 q/dq of x on (delta, zp) with clamp range ``qrange``,
    the result cast to ``dtype`` (flash_attention.py:64-69)."""
    nb, pb = qrange
    xq = torch.clamp(torch.round(x.float() * (1.0 / delta)) + zp, nb, pb)
    return (delta * (xq - zp)).to(dtype)


def fqk_prepass_plain(k, v, sc, ranges, int8_pv: bool = False):
    """The fqk pre-pass (``_fqk_kernel``'s ``_prep``): k and v
    fake-quantized once to their carrier dtype, ``(kf, vf)``; with
    ``int8_pv``, v as centered int8 codes instead, transposed to (B*H, D,
    Tk), and their column sums over the keys (B*H, D) int32:
    ``(kf, vt, vsum)``."""
    mdt = k.dtype
    kf = fake_quant_tile(k, sc[2], sc[3], ranges[1], mdt)
    if not int8_pv:
        return kf, fake_quant_tile(v, sc[4], sc[5], ranges[2], mdt)
    v8 = quant_i8(v.float(), sc[4], sc[5], ranges[2])
    vsum = v8.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return kf, v8.transpose(1, 2).contiguous(), vsum


def flash_fqk_plain(q, k, v, sc, sm_scale: float, ranges, qrange=None,
                    zp_zero: bool = False, int8_pv: bool = False,
                    block_k: int = BLOCK_K) -> torch.Tensor:
    """Mode ``fqk`` (``_fqk_kernel``): q/k/v fake-quantized to their
    carrier dtype, products of those values with f32 sums, the softmax
    quantizer's levels (``qrange``) or p cast to the carrier dtype before
    P @ V; ``int8_pv``: P @ V on p levels and v codes, exact."""
    mdt = q.dtype
    dq, zq, dv, zv, dw, zw = (sc[i] for i in (0, 1, 4, 5, 6, 7))
    use_pv = qrange is not None and int8_pv
    kf, *vpre = fqk_prepass_plain(k, v, sc, ranges, use_pv)
    qf = fake_quant_tile(q, dq, zq, ranges[0], mdt)
    s = (qf.float() @ kf.float().transpose(1, 2)) * sm_scale
    e, rebase, l = _blocked_softmax(s, key_block(k.shape[1], block_k))
    if use_pv:
        v8 = vpre[0].transpose(1, 2)
        nb, pb = qrange
        x = _p_round(e, rebase, 1.0 / (l * dw))
        p_q = torch.clamp(x, max=pb) if zp_zero else \
            torch.clamp(x + zw, nb, pb)
        return _int8_pv(p_q, zw, v8, zv, dw * dv).to(mdt)
    vf = vpre[0].float()
    if qrange is not None:
        x = _p_round(e, rebase, 1.0 / (l * dw))
        p = _p_levels(x, zw, qrange, zp_zero)
        return (dw * (p.to(mdt).float() @ vf)).to(mdt)
    p = e * (rebase * (1.0 / l))
    return (p.to(mdt).float() @ vf).to(mdt)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _n_blocks(name: str, tk: int, block_k: int, tile: int = 32) -> int:
    bk = key_block(tk, block_k)
    if bk % tile:
        raise ValueError(f"{name}: key block {bk} is not a multiple of "
                         f"{tile}")
    nk = -(-tk // bk)
    if nk > MAX_KEY_BLOCKS:
        raise ValueError(f"{name}: {nk} key blocks > {MAX_KEY_BLOCKS}")
    return bk


def flash_fp(q, k, v, sm_scale: float) -> torch.Tensor:
    """softmax(q k^T sm_scale) v over (B*H, T, D) float32."""
    if not _device_or_raise("flash_fp", q):
        return flash_fp_plain(q, k, v, sm_scale)
    return _launch_f32("flash_fp", q, k, v, sm_scale, None, None, False,
                       BLOCK_K)


def flash_pquant(q, k, v, sm_scale: float, dz: torch.Tensor, qrange,
                 zp_zero: bool = False,
                 block_k: int = BLOCK_K) -> torch.Tensor:
    """Softmax output fake-quantized on the grid ``dz`` = [delta, zp]
    (device tensor) with clamp range ``qrange``, then @ v."""
    if not _device_or_raise("flash_pquant", q):
        return flash_pquant_plain(q, k, v, sm_scale, dz, qrange, zp_zero,
                                  block_k)
    return _launch_f32("flash_pquant", q, k, v, sm_scale, dz, qrange,
                       zp_zero, block_k)


def _launch_f32(name, q, k, v, sm_scale, dz, qrange, zp_zero, block_k):
    bh, tq, tk, d = _check_dims(name, q, k, v)
    dev = q.device
    check("q", q, torch.float32, (bh, tq, d), dev)
    check("k", k, torch.float32, (bh, tk, d), dev)
    check("v", v, torch.float32, (bh, tk, d), dev)
    if dz is not None:
        check("dz", dz, torch.float32, (2,), dev)
    bk = _n_blocks(name, tk, block_k)
    nb, pb = qrange if qrange is not None else (0, 0)
    lib = build()
    out = torch.empty((bh, tq, d), dtype=torch.float32, device=dev)
    err = lib.tfmq_flash_f32(ptr(q), ptr(k), ptr(v), ptr(dz), ptr(out), bh,
                             tq, tk, d, bk, float(sm_scale),
                             int(dz is not None), float(nb), float(pb),
                             int(bool(zp_zero)), dev.index or 0,
                             _stream(dev))
    launch_check(name, err)
    LAUNCHES[name] += 1
    return out


def flash_int8(q8, k8, v8, qsum, ksum, vsum, sc, sm_scale: float,
               qrange=None, block_k: int = BLOCK_K) -> torch.Tensor:
    """Attention on centered int8 codes (B*H, T, D) with their row sums
    ``qsum`` (B*H, Tq) and ``ksum`` (B*H, Tk) f32, the column sums of v
    ``vsum`` (B*H, D) int32, and the grids ``sc`` = [dq, zq, dk, zk, dv,
    zv, dw, zw] (device tensor). ``qrange``: the softmax quantizer's clamp
    range, or None for none."""
    if not _device_or_raise("flash_int8", q8):
        return flash_int8_plain(q8, k8, v8, qsum, ksum, vsum, sc, sm_scale,
                                qrange, block_k)
    bh, tq, tk, d = _check_dims("flash_int8", q8, k8, v8)
    dev = q8.device
    check("q8", q8, torch.int8, (bh, tq, d), dev)
    check("k8", k8, torch.int8, (bh, tk, d), dev)
    check("v8", v8, torch.int8, (bh, tk, d), dev)
    check("qsum", qsum, torch.float32, (bh, tq), dev)
    check("ksum", ksum, torch.float32, (bh, tk), dev)
    check("vsum", vsum, torch.int32, (bh, d), dev)
    check("sc", sc, torch.float32, (8,), dev)
    if qrange is not None and not (qrange[0] == 0 and qrange[1] <= 255):
        raise ValueError(f"flash_int8: softmax grid {qrange} does not fit "
                         "centered int8 levels")
    bk = _n_blocks("flash_int8", tk, block_k, INT8_KEY_PAD)
    nb, pb = qrange if qrange is not None else (0, 0)
    dp, tkp, vt = int8_scratch(bh, tk, d, dev)
    lib = build()
    out = torch.empty((bh, tq, d), dtype=torch.float32, device=dev)
    err = lib.tfmq_flash_int8(ptr(q8), ptr(k8), ptr(v8), ptr(qsum),
                              ptr(ksum), ptr(vsum), ptr(sc), ptr(out),
                              ptr(vt), bh, tq, tk, d, dp, tkp, bk,
                              float(sm_scale), int(qrange is not None),
                              float(nb), float(pb), dev.index or 0,
                              _stream(dev))
    launch_check("flash_int8", err)
    LAUNCHES["flash_int8"] += 1
    return out


# the int8 kernel: head dims padded to one of these (multiples of the s8
# tensor-core product's depth, 32), keys of the v-code scratch to a
# multiple of INT8_KEY_PAD (every key tile divides it, and so must the key
# block)
INT8_HEAD_DIMS = (64, 96, 160, 384)
INT8_KEY_PAD = 64


def int8_scratch(bh: int, tk: int, d: int, dev):
    """``flash_int8``'s v-code scratch, allocated (``torch.empty``): vt
    (B*H, DP, Tkp) int8, which its pre-pass fills with the v codes
    transposed (keys contiguous per head-dim column, the layout of the s8
    tensor-core operand of P @ V), zero past Tk and D; DP is the padded
    head dim, Tkp the keys rounded up to 64. Returns (DP, Tkp, vt)."""
    dp = next(p for p in INT8_HEAD_DIMS if d <= p)
    tkp = -(-tk // INT8_KEY_PAD) * INT8_KEY_PAD
    return dp, tkp, torch.empty((bh, dp, tkp), dtype=torch.int8, device=dev)


def int8_vt_plain(v8: torch.Tensor) -> torch.Tensor:
    """The pre-pass of ``flash_int8`` in PyTorch ops: v codes (B*H, Tk, D)
    int8 -> (B*H, DP, Tkp), transposed and zero-padded (``int8_scratch``'s
    shape)."""
    bh, tk, d = v8.shape
    dp, tkp, _ = int8_scratch(0, tk, d, v8.device)
    vt = torch.zeros((bh, dp, tkp), dtype=torch.int8, device=v8.device)
    vt[:, :d, :tk] = v8.transpose(1, 2)
    return vt


def int8_vt(v8: torch.Tensor) -> torch.Tensor:
    """The pre-pass kernel of ``flash_int8`` alone on CUDA v codes, in
    ``int8_vt_plain``'s layout. Used by the tests; ``flash_int8`` launches
    the pre-pass itself."""
    if not _device_or_raise("int8_vt", v8):
        raise ValueError("int8_vt: the kernel takes CUDA tensors; "
                         "int8_vt_plain is the CPU version")
    bh, tk, d = v8.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"int8_vt: head dim {d} > {MAX_HEAD_DIM}")
    dev = v8.device
    check("v8", v8, torch.int8, (bh, tk, d), dev)
    dp, tkp, vt = int8_scratch(bh, tk, d, dev)
    err = build().tfmq_int8_vt(ptr(v8), ptr(vt), bh, tk, d, dp, tkp,
                               dev.index or 0, _stream(dev))
    launch_check("int8_vt", err)
    return vt


# the fqk kernels: head dims padded to one of these, keys to a multiple of
# FQK_KEY_PAD (every key tile divides it, and so must the key block; the
# pre-pass writes one row of v-code column sums per FQK_KEY_PAD keys)
FQK_HEAD_DIMS = (48, 80, 160, 384)
FQK_KEY_PAD = 64


def fqk_scratch(bh: int, tk: int, d: int, int8_pv: bool, dev):
    """The pre-pass's outputs, allocated (``torch.empty``): kf (B*H, Tkp,
    DP) bf16, and vf (B*H, Tkp, DP) bf16 or vt (B*H, DP, Tkp) int8 with
    vpart (B*H, Tkp / 64, DP) int32; DP is the padded head dim, Tkp the
    keys rounded up to 64."""
    dp = next(p for p in FQK_HEAD_DIMS if d <= p)
    tkp = -(-tk // FQK_KEY_PAD) * FQK_KEY_PAD
    npre = tkp // FQK_KEY_PAD
    kf = torch.empty((bh, tkp, dp), dtype=torch.bfloat16, device=dev)
    if int8_pv:
        return dp, tkp, (kf, None,
                         torch.empty((bh, dp, tkp), dtype=torch.int8,
                                     device=dev),
                         torch.empty((bh, npre, dp), dtype=torch.int32,
                                     device=dev))
    return dp, tkp, (kf, torch.empty_like(kf), None, None)


def _ranges(ranges):
    return [float(a) for rg in ranges for a in rg]


def fqk_prepass(k, v, sc, ranges, int8_pv: bool = False):
    """The fqk pre-pass kernel alone on CUDA k/v (B*H, Tk, D) bf16: its
    scratch cut to (Tk, D), in ``fqk_prepass_plain``'s layout (vsum: the
    per-tile column sums added). Used by the tests; ``flash_fqk`` launches
    the pre-pass itself."""
    if not _device_or_raise("fqk_prepass", k):
        raise ValueError("fqk_prepass: the kernel takes CUDA tensors; "
                         "fqk_prepass_plain is the CPU version")
    bh, _, tk, d = _check_dims("fqk_prepass", k, k, v)
    dev = k.device
    check("k", k, torch.bfloat16, (bh, tk, d), dev)
    check("v", v, torch.bfloat16, (bh, tk, d), dev)
    check("sc", sc, torch.float32, (8,), dev)
    dp, tkp, (kf, vf, vt, vpart) = fqk_scratch(bh, tk, d, int8_pv, dev)
    lib = build()
    err = lib.tfmq_fqk_prepass(ptr(k), ptr(v), ptr(sc), ptr(kf), ptr(vf),
                               ptr(vt), ptr(vpart), bh, tk, d, dp, tkp,
                               int(int8_pv), *_ranges(ranges[1:]),
                               dev.index or 0, _stream(dev))
    launch_check("fqk_prepass", err)
    if not int8_pv:
        return kf[:, :tk, :d], vf[:, :tk, :d]
    return kf[:, :tk, :d], vt[:, :d, :tk], vpart.sum(dim=1,
                                                      dtype=torch.int32)[:, :d]


def flash_fqk(q, k, v, sc, sm_scale: float, ranges, qrange=None,
              zp_zero: bool = False, int8_pv: bool = False,
              block_k: int = BLOCK_K) -> torch.Tensor:
    """Mode ``fqk`` over (B*H, T, D) bf16 q/k/v with the grids ``sc`` =
    [dq, zq, dk, zk, dv, zv, dw, zw] (device tensor), the q/k/v clamp
    ranges ``ranges`` and the softmax quantizer's clamp range ``qrange``
    (None: no softmax quantizer) -> bf16. ``int8_pv`` (8-bit softmax and
    v grids): P @ V on p levels and v codes. On the card one call runs the
    pre-pass (k/v fake-quantized once per head into scratch) and the main
    kernel: one launch counted."""
    if not _device_or_raise("flash_fqk", q):
        return flash_fqk_plain(q, k, v, sc, sm_scale, ranges, qrange,
                               zp_zero, int8_pv, block_k)
    bh, tq, tk, d = _check_dims("flash_fqk", q, k, v)
    dev = q.device
    check("q", q, torch.bfloat16, (bh, tq, d), dev)
    check("k", k, torch.bfloat16, (bh, tk, d), dev)
    check("v", v, torch.bfloat16, (bh, tk, d), dev)
    check("sc", sc, torch.float32, (8,), dev)
    if int8_pv and not (qrange is not None and qrange[0] == 0
                        and qrange[1] <= 255 and ranges[2][0] == 0
                        and ranges[2][1] <= 255):
        raise ValueError("flash_fqk: int8_pv needs 8-bit softmax and v "
                         "grids")
    bk = _n_blocks("flash_fqk", tk, block_k, FQK_KEY_PAD)
    wnb, wpb = qrange if qrange is not None else (0, 0)
    mode = 0 if qrange is None else (2 if int8_pv else 1)
    dp, tkp, (kf, vf, vt, vpart) = fqk_scratch(bh, tk, d, mode == 2, dev)
    lib = build()
    out = torch.empty((bh, tq, d), dtype=torch.bfloat16, device=dev)
    err = lib.tfmq_flash_fqk(ptr(q), ptr(k), ptr(v), ptr(sc), ptr(out),
                             ptr(kf), ptr(vf), ptr(vt), ptr(vpart), bh, tq,
                             tk, d, dp, tkp, bk, float(sm_scale), mode,
                             int(bool(zp_zero)), *_ranges(ranges),
                             float(wnb), float(wpb), dev.index or 0,
                             _stream(dev))
    launch_check("flash_fqk", err)
    LAUNCHES["flash_fqk"] += 1
    return out


# ---------------------------------------------------------------------------
# entry point over (B, H, T, D), as the JAX ``flash_attention``
# ---------------------------------------------------------------------------

def quant_i8(x: torch.Tensor, delta, zp, qrange) -> torch.Tensor:
    """Centered int8 act codes clip(round(x / delta) + zp) - 128
    (``_quant_i8``)."""
    nb, pb = qrange
    xq = torch.clamp(torch.round(x * (1.0 / delta)) + zp, nb, pb)
    return (xq - 128.0).to(torch.int8)


def int8_operands(q, k, v, qkv_quant, qkv_ranges):
    """q/k/v (B*H, T, D) -> centered codes, row sums and v column sums,
    outside the kernel in PyTorch ops (``_flash_call``, mode int8)."""
    (dq, zq), (dk, zk), (dv, zv) = qkv_quant
    q8 = quant_i8(q, dq, zq, qkv_ranges[0])
    k8 = quant_i8(k, dk, zk, qkv_ranges[1])
    v8 = quant_i8(v, dv, zv, qkv_ranges[2])
    qsum = q8.to(torch.int32).sum(dim=-1).float()
    ksum = k8.to(torch.int32).sum(dim=-1).float()
    vsum = v8.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return q8, k8, v8, qsum, ksum, vsum


def _scalar(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=dev).reshape(())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float = 1.0, p_quant: Optional[Tuple] = None,
                    qkv_quant: Optional[Tuple] = None,
                    qrange: Optional[Tuple[int, int]] = None,
                    qkv_ranges: Optional[Tuple] = None,
                    int8_matmul: bool = True,
                    block_k: Optional[int] = None,
                    p_always_zero: bool = False,
                    int8_pv: bool = False) -> torch.Tensor:
    """Blockwise attention over (B, H, T, D) tensors.

    ``p_quant``: optional (delta, zp) of the softmax-output quantizer, with
    clamp range ``qrange`` (default (0, 255)). ``qkv_quant``: optional
    ((dq, zq), (dk, zk), (dv, zv)) per-tensor grids with ranges
    ``qkv_ranges`` (default (0, 255) each): q/k/v are quantized to int8
    codes and both products run on them (mode int8), or, with
    ``int8_matmul=False``, fake-quantized to their own dtype (bf16 in the
    fast deploy) in the kernel with products of those values (mode fqk;
    ``int8_pv``: P @ V on levels and codes where both grids fit 8 bits).
    Without ``qkv_quant``: mode fp or, with ``p_quant``, pquant, on f32
    operands. ``block_k``: the key block of the softmax quantizer's
    rounding (default 2048, as the Pallas call)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev = q.device
    block_k = BLOCK_K if block_k is None else block_k
    if qrange is None and p_quant is not None:
        qrange = (0, 255)
    qr = None if p_quant is None else tuple(qrange)
    dw, zw = p_quant if p_quant is not None else (1.0, 0.0)
    if qkv_quant is not None and not int8_matmul:
        qkv_ranges = qkv_ranges or ((0, 255),) * 3
        sc = torch.stack([_scalar(a, dev) for pair in qkv_quant
                          for a in pair] + [_scalar(dw, dev),
                                            _scalar(zw, dev)])
        use_pv = bool(int8_pv and qr is not None and qr[0] == 0
                      and qr[1] <= 255 and qkv_ranges[2][0] == 0
                      and qkv_ranges[2][1] <= 255)
        out = flash_fqk(*(x.reshape(b * h, -1, d).contiguous()
                          for x in (q, k, v)), sc, sm_scale,
                        tuple(tuple(r) for r in qkv_ranges), qr,
                        zp_zero=p_always_zero, int8_pv=use_pv,
                        block_k=block_k)
        return out.reshape(b, h, tq, d)
    qf = q.reshape(b * h, tq, d).float().contiguous()
    kf = k.reshape(b * h, tk, d).float().contiguous()
    vf = v.reshape(b * h, tk, d).float().contiguous()
    if qkv_quant is not None:
        qkv_ranges = qkv_ranges or ((0, 255),) * 3
        ops = int8_operands(qf, kf, vf, qkv_quant, qkv_ranges)
        sc = torch.stack([_scalar(a, dev) for pair in qkv_quant
                          for a in pair] + [_scalar(dw, dev),
                                            _scalar(zw, dev)])
        out = flash_int8(*ops, sc, sm_scale, qr, block_k=block_k)
    elif p_quant is not None:
        dz = torch.stack([_scalar(p_quant[0], dev), _scalar(p_quant[1], dev)])
        out = flash_pquant(qf, kf, vf, sm_scale, dz, qr,
                           zp_zero=p_always_zero, block_k=block_k)
    else:
        out = flash_fp(qf, kf, vf, sm_scale)
    return out.reshape(b, h, tq, d)
