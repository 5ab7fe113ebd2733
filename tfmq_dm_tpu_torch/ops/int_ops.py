"""Integer deployment carriers (port of the parts of
``tfmq_dm_tpu/ops/int_ops.py`` that the int4-serving path uses).

Weights are stored as centered integer codes (q' = q - 2^{b-1}) with
per-channel scales; ``quantize_weight_int`` reproduces the calibrated
weights exactly, AdaRound hard rounding included. The exact int8
conv/linear with border maps (``int8_conv2d`` / ``int8_linear``) serve the
deployment without ``--int4-serving`` and wait for that slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..quant.quantizer import QCfg, broadcast_channel


@dataclasses.dataclass
class IntWeight:
    """Deployment-quantized weight: centered int8 codes + scales. ``sym``:
    symmetric grid (zero point structurally 0)."""

    w_q: torch.Tensor       # int8, centered (w_int - 2^{b-1}; sym: as-is)
    delta: torch.Tensor     # (O,) per-channel scale
    zp_c: torch.Tensor      # (O,) centered zero point, float
    wsum: torch.Tensor      # (O,) sum of centered codes, int32
    k: int                  # reduction volume (kh*kw*Cin or Cin)
    bits: int
    sym: bool = False


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
    return IntWeight(
        w_q=w_q.to(torch.int8),
        delta=delta.reshape(-1).float(),
        zp_c=(zp.reshape(-1) - off).float(),
        wsum=w_q.to(torch.int32).sum(dim=tuple(range(w.ndim - 1))),
        k=math.prod(w.shape[:-1]),
        bits=cfg.bits, sym=sym)


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


def dequant_weight(iw: IntWeight, dtype=torch.float32) -> torch.Tensor:
    """w_dq = delta * (w_q' - zp_c)."""
    wq = iw.w_q.float()
    d = iw.delta.reshape((1,) * (wq.ndim - 1) + (-1,))
    z = iw.zp_c.reshape((1,) * (wq.ndim - 1) + (-1,))
    return (d * (wq - z)).to(dtype)
