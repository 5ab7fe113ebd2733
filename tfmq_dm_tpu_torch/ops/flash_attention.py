"""Flash-attention kernels: the port's counterpart of
``tfmq_dm_tpu/ops/flash_attention.py``.

- ``flash_fp``      replaces mode ``fp``     (``_fp_kernel``)
- ``flash_pquant``  replaces mode ``pquant`` (``_quant_kernel``)
- ``flash_int8``    replaces mode ``int8``   (``_int8_kernel``)

All three are CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), built
with ``nvcc`` into ``_build/`` at first use and called through a plain C
interface with ``ctypes``. Each wrapper takes (B*H, T, D) float32 tensors
and dispatches on their device: a CPU tensor takes the plain PyTorch
version beside it (the tests use it); a CUDA tensor launches the kernel,
or raises. Nothing falls back from one to the other. The kernels take
head dims up to ``MAX_HEAD_DIM``; a larger one raises.

The plain versions materialize the (T, T) scores and round where the
kernels round. The kernels take the softmax quantizer's operand as
``round(exp(s - m) * (1 / (l * delta)))`` with the final row max ``m``
and denominator ``l`` (they recompute the scores in a second pass rather
than cache them), which for Tk <= 2048 is the Pallas kernel's own operand;
the plain versions take the same. They differ from the kernels in the
order of f32 sums only, so a quantized probability at a rounding boundary
may flip by one level.

``flash_attention`` over (B, H, T, D) mirrors the JAX entry point: it
quantizes q/k/v to centered int8 codes with their row sums outside the
kernel (``_quant_i8``), as the JAX call does, and picks the mode.
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

# launches of each kernel since the last reset (chip_smoke.py reads these)
LAUNCHES = {"flash_fp": 0, "flash_pquant": 0, "flash_int8": 0}


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfmq_flash_f32.argtypes = [p] * 5 + [i] * 4 + [f, i, f, f, i, i, p]
    lib.tfmq_flash_f32.restype = i
    lib.tfmq_flash_int8.argtypes = [p] * 8 + [i] * 4 + [f, i, f, f, i, p]
    lib.tfmq_flash_int8.restype = i


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

def _row_softmax_parts(s: torch.Tensor):
    """e = exp(s - rowmax), l = sum e."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e, e.sum(dim=-1, keepdim=True)


def _p_levels(e, l, delta, zp, qrange, zp_zero):
    """Quantized softmax levels (p_q - zp) of e / l on the (delta, zp)
    grid, as ``_quant_kernel``: one divide per row, then round."""
    nb, pb = qrange
    x = torch.round(e * (1.0 / (l * delta)))
    if zp_zero:
        return torch.clamp(x, max=pb)
    return torch.clamp(x + zp, nb, pb) - zp


def flash_fp_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    s = (q @ k.transpose(1, 2)) * sm_scale
    e, l = _row_softmax_parts(s)
    return (e @ v) / l


def flash_pquant_plain(q, k, v, sm_scale: float, dz: torch.Tensor,
                       qrange, zp_zero: bool) -> torch.Tensor:
    s = (q @ k.transpose(1, 2)) * sm_scale
    e, l = _row_softmax_parts(s)
    delta, zp = dz[0], dz[1]
    return delta * (_p_levels(e, l, delta, zp, qrange, zp_zero) @ v)


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


def flash_int8_plain(q8, k8, v8, qsum, ksum, vsum, sc, sm_scale: float,
                     qrange=None) -> torch.Tensor:
    """``qrange`` None: no softmax quantizer (p stays f32, v dequantized);
    else p levels and v codes, summed exactly."""
    s = _int8_scores(q8, k8, qsum, ksum, sc, sm_scale)
    e, l = _row_softmax_parts(s)
    dv, zv, dw, zw = sc[4], sc[5], sc[6], sc[7]
    if qrange is None:
        vdq = dv * (v8.float() - (zv - 128.0))
        return (e @ vdq) / l
    nb, pb = qrange
    p_q = torch.clamp(torch.round(e * (1.0 / (l * dw))) + zw, nb, pb)
    corr = (p_q - zw).double() @ (v8.double() - (zv.double() - 128.0))
    return (dw * dv) * corr.float()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_fp(q, k, v, sm_scale: float) -> torch.Tensor:
    """softmax(q k^T sm_scale) v over (B*H, T, D) float32."""
    if not _device_or_raise("flash_fp", q):
        return flash_fp_plain(q, k, v, sm_scale)
    return _launch_f32("flash_fp", q, k, v, sm_scale, None, None, False)


def flash_pquant(q, k, v, sm_scale: float, dz: torch.Tensor, qrange,
                 zp_zero: bool = False) -> torch.Tensor:
    """Softmax output fake-quantized on the grid ``dz`` = [delta, zp]
    (device tensor) with clamp range ``qrange``, then @ v."""
    if not _device_or_raise("flash_pquant", q):
        return flash_pquant_plain(q, k, v, sm_scale, dz, qrange, zp_zero)
    return _launch_f32("flash_pquant", q, k, v, sm_scale, dz, qrange,
                       zp_zero)


def _launch_f32(name, q, k, v, sm_scale, dz, qrange, zp_zero):
    bh, tq, tk, d = _check_dims(name, q, k, v)
    dev = q.device
    check("q", q, torch.float32, (bh, tq, d), dev)
    check("k", k, torch.float32, (bh, tk, d), dev)
    check("v", v, torch.float32, (bh, tk, d), dev)
    if dz is not None:
        check("dz", dz, torch.float32, (2,), dev)
    nb, pb = qrange if qrange is not None else (0, 0)
    lib = build()
    out = torch.empty((bh, tq, d), dtype=torch.float32, device=dev)
    err = lib.tfmq_flash_f32(ptr(q), ptr(k), ptr(v), ptr(dz), ptr(out), bh,
                             tq, tk, d, float(sm_scale), int(dz is not None),
                             float(nb), float(pb), int(bool(zp_zero)),
                             dev.index or 0, _stream(dev))
    launch_check(name, err)
    LAUNCHES[name] += 1
    return out


def flash_int8(q8, k8, v8, qsum, ksum, vsum, sc, sm_scale: float,
               qrange=None) -> torch.Tensor:
    """Attention on centered int8 codes (B*H, T, D) with their row sums
    ``qsum`` (B*H, Tq) and ``ksum`` (B*H, Tk) f32, the column sums of v
    ``vsum`` (B*H, D) int32, and the grids ``sc`` = [dq, zq, dk, zk, dv,
    zv, dw, zw] (device tensor). ``qrange``: the softmax quantizer's clamp
    range, or None for none."""
    if not _device_or_raise("flash_int8", q8):
        return flash_int8_plain(q8, k8, v8, qsum, ksum, vsum, sc, sm_scale,
                                qrange)
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
    nb, pb = qrange if qrange is not None else (0, 0)
    lib = build()
    out = torch.empty((bh, tq, d), dtype=torch.float32, device=dev)
    err = lib.tfmq_flash_int8(ptr(q8), ptr(k8), ptr(v8), ptr(qsum),
                              ptr(ksum), ptr(vsum), ptr(sc), ptr(out), bh,
                              tq, tk, d, float(sm_scale),
                              int(qrange is not None), float(nb), float(pb),
                              dev.index or 0, _stream(dev))
    launch_check("flash_int8", err)
    LAUNCHES["flash_int8"] += 1
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
                    p_always_zero: bool = False) -> torch.Tensor:
    """Blockwise attention over (B, H, T, D) float32 tensors.

    ``p_quant``: optional (delta, zp) of the softmax-output quantizer, with
    clamp range ``qrange`` (default (0, 255)). ``qkv_quant``: optional
    ((dq, zq), (dk, zk), (dv, zv)) per-tensor grids with ranges
    ``qkv_ranges`` (default (0, 255) each): q/k/v are quantized to int8
    codes and both products run on them (mode int8); without it, mode fp
    or, with ``p_quant``, pquant."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev = q.device
    qf = q.reshape(b * h, tq, d).float().contiguous()
    kf = k.reshape(b * h, tk, d).float().contiguous()
    vf = v.reshape(b * h, tk, d).float().contiguous()
    if qrange is None and p_quant is not None:
        qrange = (0, 255)
    if qkv_quant is not None:
        qkv_ranges = qkv_ranges or ((0, 255),) * 3
        ops = int8_operands(qf, kf, vf, qkv_quant, qkv_ranges)
        dw, zw = p_quant if p_quant is not None else (1.0, 0.0)
        sc = torch.stack([_scalar(a, dev) for pair in qkv_quant
                          for a in pair] + [_scalar(dw, dev),
                                            _scalar(zw, dev)])
        out = flash_int8(*ops, sc, sm_scale,
                         None if p_quant is None else tuple(qrange))
    elif p_quant is not None:
        dz = torch.stack([_scalar(p_quant[0], dev), _scalar(p_quant[1], dev)])
        out = flash_pquant(qf, kf, vf, sm_scale, dz, tuple(qrange),
                           zp_zero=p_always_zero)
    else:
        out = flash_fp(qf, kf, vf, sm_scale)
    return out.reshape(b, h, tq, d)
