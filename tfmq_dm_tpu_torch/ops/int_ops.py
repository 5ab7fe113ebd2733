"""Integer deployment ops (port of ``tfmq_dm_tpu/ops/int_ops.py``): exact
int8 conv and matmul with zero-point corrections.

Weights are stored as centered integer codes (q' = q - 2^{b-1}) with
per-channel scales; ``quantize_weight_int`` reproduces the calibrated
weights exactly, AdaRound hard rounding included. Activations are
quantized per tensor to centered int8 codes, and

    conv(x_dq, w_dq) = dx dw (conv0(x', w') - zp_w' S0(x) - zp_x' W
                              + zp_x' zp_w' cin V)

with conv0 on zero-padded codes, S0 the windowed sum of the codes, and the
border maps W (sum of w' over the taps valid at each output position) and
V (count of valid taps), which depend only on weights and geometry
(``deploy.specialize_maps`` computes them once). The int32 products run
on the hand-written int8 GEMM (``ops/int8_kernels.py``): an f32 product of
codes would not be exact here, since a sum of K = 9 Cin products of up to
128 x 128 passes 2^24 once K > 1024.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..quant.quantizer import QCfg, broadcast_channel
from . import int8_kernels


@dataclasses.dataclass
class IntWeight:
    """Deployment-quantized weight: centered int8 codes + scales. ``sym``:
    symmetric grid (zero point structurally 0, so the activation-sum
    correction vanishes). ``w_map`` / ``v_map``: the border maps of one
    conv geometry (``deploy.specialize_maps``); without them the conv
    computes them per call. ``w_t``: the codes K-major, as the int8 GEMM
    reads them."""

    w_q: torch.Tensor       # int8, centered (w_int - 2^{b-1}; sym: as-is)
    delta: torch.Tensor     # (O,) per-channel scale
    zp_c: torch.Tensor      # (O,) centered zero point, float
    wsum: torch.Tensor      # (O,) sum of centered codes, int32
    k: int                  # reduction volume (kh*kw*Cin or Cin)
    bits: int
    sym: bool = False
    w_map: Optional[torch.Tensor] = None   # (1, Ho, Wo, O) f32
    v_map: Optional[torch.Tensor] = None   # (1, Ho, Wo, 1) f32 (asym only)
    # the codes K-major, (O, K padded to 16) (int8_kernels.kmajor): the
    # layout the int8 GEMM reads, made once here rather than per call
    w_t: Optional[torch.Tensor] = None


@dataclasses.dataclass
class FPWeight:
    """Carrier for >8-bit weight grids: the fake-quantized weights,
    materialized offline; the layer runs a plain fp conv/matmul."""

    w: torch.Tensor


def fits_int8(cfg: QCfg) -> bool:
    """Whether this grid's centered codes fit int8 (wider grids would
    wrap in int8 storage)."""
    return cfg.bits <= 8


def quantize_weight_int(w: torch.Tensor, delta: torch.Tensor,
                        zp: torch.Tensor, cfg: QCfg,
                        alpha: Optional[torch.Tensor] = None) -> IntWeight:
    """Offline weight quantization to the centered integer grid. With
    ``alpha``, AdaRound hard rounding (floor + (alpha >= 0),
    adaptive_rounding.py:58-63), so an artifact calibrated with
    reconstruction deploys exactly its calibrated weights."""
    sym = cfg.qrange[0] < 0
    off = 0 if sym else 2 ** (cfg.bits - 1)
    d = broadcast_channel(delta, w.shape)
    inv_d = 1.0 / d
    if alpha is not None:
        w_int = torch.floor(w * inv_d) + (alpha >= 0).to(w.dtype)
    else:
        w_int = torch.round(w * inv_d)
    zpb = broadcast_channel(zp, w.shape)
    nb, pb = cfg.qrange
    w_q = torch.clamp(w_int + zpb, nb, pb) - off
    codes = w_q.to(torch.int8)
    return IntWeight(
        w_q=codes,
        delta=delta.reshape(-1).float(),
        zp_c=(zp.reshape(-1) - off).float(),
        wsum=w_q.to(torch.int32).sum(dim=tuple(range(w.ndim - 1))),
        k=math.prod(w.shape[:-1]),
        bits=cfg.bits, sym=sym, w_t=int8_kernels.kmajor(codes))


def quantize_act_int8(x: torch.Tensor, delta: torch.Tensor,
                      zp: torch.Tensor,
                      cfg: QCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor activation quantization to centered int8 codes; returns
    (x_q' int8, zp_c f32 scalar). The round runs in f32."""
    off = 2 ** (cfg.bits - 1)
    nb, pb = cfg.qrange
    x_q = torch.clamp(torch.round(x.float() * (1.0 / delta)) + zp,
                      nb, pb) - off
    return x_q.to(torch.int8), (zp - off).float()


def border_maps(w_q: torch.Tensor, hw, stride: int, pads):
    """(W, V) of a conv geometry, exactly: W (1, Ho, Wo, O) the sum of
    the codes w' over the taps that fall inside the input at each output
    position, V (1, Ho, Wo, 1) the count of those taps, as f32 (JAX: the
    ones-input int32 convs of int_ops.int8_conv2d)."""
    kh, kw = w_q.shape[:2]
    h, w = hw
    ones = torch.ones((1, h, w, 1), dtype=torch.float64, device=w_q.device)
    valid = int8_kernels.windows(ones, kh, kw, stride, pads)
    valid = valid.reshape(valid.shape[1], valid.shape[2], kh * kw)
    tap_sums = w_q.double().sum(dim=2).reshape(kh * kw, -1)
    w_map = (valid @ tap_sums).float()[None]
    v_map = valid.sum(dim=-1, keepdim=True).float()[None]
    return w_map, v_map


def _window_sum(x_q: torch.Tensor, kh: int, kw: int, stride: int, pads):
    """S0: the windowed sum of zero-padded codes, int32 (B, Ho, Wo, 1)."""
    xsum = x_q.to(torch.int32).sum(dim=-1, keepdim=True, dtype=torch.int32)
    win = int8_kernels.windows(xsum, kh, kw, stride, pads)
    return win.sum(dim=(3, 4), dtype=torch.int32)


def int8_conv2d(x_q: torch.Tensor, zp_xc: torch.Tensor, dx: torch.Tensor,
                iw: IntWeight, b: Optional[torch.Tensor] = None,
                stride: int = 1, pads=((1, 1), (1, 1)),
                out_dtype=torch.float32) -> torch.Tensor:
    """Exact quantized conv over NHWC codes: the int32 product of
    zero-padded codes (``int8_kernels.int8_conv_acc``), then the
    zero-point corrections and the dequant epilogue in f32, in the JAX
    package's order (int_ops.py:132-193)."""
    kh, kw, cin, _ = iw.w_q.shape
    acc = int8_kernels.int8_conv_acc(x_q, iw.w_q, stride, pads,
                                     w_t=iw.w_t)
    w_map, v_map = iw.w_map, iw.v_map
    if w_map is None or (v_map is None and not iw.sym):
        w_map, v_map = border_maps(iw.w_q, x_q.shape[1:3], stride, pads)
    corr = acc.float() - zp_xc * w_map
    if not iw.sym:
        s = _window_sum(x_q, kh, kw, stride, pads)
        corr = (corr - iw.zp_c * s.float()
                + (cin * zp_xc) * v_map * iw.zp_c)
    out = (dx * iw.delta) * corr
    if b is not None:
        out = out + b
    return out.to(out_dtype)


def int8_linear(x_q: torch.Tensor, zp_xc: torch.Tensor, dx: torch.Tensor,
                iw: IntWeight, b: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Exact quantized matmul over (..., K) codes: the hand-written
    ``int8_matmul_pre`` with its fused epilogue (the same algebra as
    int_ops.int8_linear, terms summed in the Pallas kernel's order; a
    symmetric grid passes zp_w' = 0)."""
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, iw.k).contiguous()
    xsum = x2.to(torch.int32).sum(dim=-1, keepdim=True,
                                  dtype=torch.int32).float()
    zp_wc = torch.zeros_like(iw.zp_c) if iw.sym else iw.zp_c
    bias = None if b is None else b.float().contiguous()
    out = int8_kernels.int8_matmul_pre(
        x2, xsum, iw.w_q, iw.delta, zp_wc, iw.wsum.float(), dx, zp_xc,
        bias, out_dtype=out_dtype, w_t=iw.w_t)
    return out.reshape(lead + (out.shape[-1],))


def dequant_weight(iw: IntWeight, dtype=torch.float32) -> torch.Tensor:
    """w_dq = delta * (w_q' - zp_c)."""
    wq = iw.w_q.float()
    d = iw.delta.reshape((1,) * (wq.ndim - 1) + (-1,))
    z = iw.zp_c.reshape((1,) * (wq.ndim - 1) + (-1,))
    return (d * (wq - z)).to(dtype)
