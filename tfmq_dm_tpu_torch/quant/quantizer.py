"""Uniform affine quantization primitives (PyTorch port of
``tfmq_dm_tpu/quant/quantizer.py``).

Same conventions as the JAX package: per-channel weight quantization runs
over the LAST axis of the weight (HWIO convs, (in, out) linears), and
quantizer params are plain tensors ``delta`` / ``zero_point``.

The arithmetic follows the JAX code operation for operation, in float32,
so that integer codes and (delta, zero_point) come out bit-equal:
quantize as ``x * (1.0 / delta)`` (never ``x / delta``), round half to
even (``torch.round``, like ``jnp.round``). Nothing here trains, so there
are no straight-through gradients; the KL and histogram scalers wait for
the calibration slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

MIN_DELTA = 1e-8


@dataclasses.dataclass(frozen=True)
class QCfg:
    """Static quantizer configuration (quant_layer.py:165-187)."""

    bits: int = 8
    symmetric: bool = False
    channel_wise: bool = False
    always_zero: bool = False

    @property
    def level(self) -> int:
        return 2 ** self.bits

    @property
    def qrange(self) -> Tuple[int, int]:
        """(NB, PB) clamp bounds, cf. quant_layer.py:223-224."""
        if self.symmetric and not self.always_zero:
            return -self.level // 2, self.level // 2 - 1
        return 0, self.level - 1


def _promote(x: torch.Tensor, p) -> torch.Tensor:
    """x in JAX's result type of (x, p): a bf16 tensor against f32
    quantizer parameters computes in f32 there, where PyTorch would keep
    bf16 for a 0-dim ``p``."""
    if isinstance(p, torch.Tensor):
        return x.to(torch.promote_types(x.dtype, p.dtype))
    return x


def fake_quant(x: torch.Tensor, delta: torch.Tensor,
               zero_point: torch.Tensor, cfg: QCfg) -> torch.Tensor:
    """Quantize-dequantize (quant_layer.py:223-227); keeps x's dtype, with
    the q/dq arithmetic in the promoted precision (f32 for bf16 x)."""
    nb, pb = cfg.qrange
    xp = _promote(x, delta)
    x_q = torch.clamp(torch.round(xp * (1.0 / delta)) + zero_point, nb, pb)
    return (delta * (x_q - zero_point)).to(x.dtype)


def quant_int(x: torch.Tensor, delta: torch.Tensor,
              zero_point: torch.Tensor, cfg: QCfg,
              dtype=torch.int8) -> torch.Tensor:
    """Integer codes (no dequant)."""
    nb, pb = cfg.qrange
    x_q = torch.clamp(torch.round(_promote(x, delta) * (1.0 / delta))
                      + zero_point, nb, pb)
    return x_q.to(dtype)


def _delta_zp_from_range(x_min: torch.Tensor, x_max: torch.Tensor,
                         cfg: QCfg):
    """(delta, zero_point) from a closed range (quant_layer.py:20-35)."""
    if cfg.symmetric:
        m = torch.maximum(x_min.abs(), x_max)
        delta = (2.0 * m) / (cfg.level - 2)
    else:
        delta = (x_max - x_min) / (cfg.level - 1)
    if cfg.always_zero:
        delta = x_max / (cfg.level - 1)
    delta = torch.clamp(delta, min=MIN_DELTA)
    if cfg.symmetric or cfg.always_zero:
        zp = torch.zeros_like(delta)
    else:
        zp = torch.round(-x_min / delta)
    return delta, zp


# Range scalers. Each takes a (C, K) matrix, one row per channel (C = 1
# for per-tensor), and returns (C,) delta and zero_point; the JAX package
# vmaps the same per-row arithmetic.

def scaler_minmax(x: torch.Tensor, cfg: QCfg):
    """quant_layer.py:20-35 — min is clamped to <= 0 and max to >= 0."""
    x_min = torch.clamp(x.amin(dim=1), max=0.0)
    x_max = torch.clamp(x.amax(dim=1), min=0.0)
    return _delta_zp_from_range(x_min, x_max, cfg)


def scaler_mse(x: torch.Tensor, cfg: QCfg, num_steps: int = 80,
               p: float = 2.4):
    """80-step range-shrink search minimizing the L_p quantization error
    (quant_layer.py:38-64); the first strictly better score wins, as in
    the JAX ``fori_loop``."""
    x_min = x.amin(dim=1)
    x_max = x.amax(dim=1)
    nb, pb = cfg.qrange
    step = torch.tensor(0.01, dtype=torch.float32, device=x.device)

    def candidate(i: int):
        shrink = 1.0 - torch.tensor(float(i), dtype=torch.float32,
                                    device=x.device) * step
        delta, zp = _delta_zp_from_range(x_min * shrink, x_max * shrink,
                                         cfg)
        d, z = delta[:, None], zp[:, None]
        x_q = torch.clamp(torch.round(x * (1.0 / d)) + z, nb, pb)
        x_dq = d * (x_q - z)
        score = torch.mean(torch.abs(x_dq - x) ** p, dim=1)
        return score, delta, zp

    best_s, best_d, best_z = candidate(0)
    for i in range(1, num_steps):
        s, d, z = candidate(i)
        better = s < best_s
        best_s = torch.where(better, s, best_s)
        best_d = torch.where(better, d, best_d)
        best_z = torch.where(better, z, best_z)
    return best_d, best_z


SCALERS = {"minmax": scaler_minmax, "mse": scaler_mse}


def init_qparams(x: torch.Tensor, cfg: QCfg, scaler: str = "mse"):
    """(delta, zero_point) for a tensor: scalars per-tensor, or (C,) over
    the last axis when ``cfg.channel_wise``."""
    fn = SCALERS[scaler]
    if cfg.channel_wise:
        return fn(x.reshape(-1, x.shape[-1]).T, cfg)
    delta, zp = fn(x.reshape(1, -1), cfg)
    return delta[0], zp[0]


def broadcast_channel(p: torch.Tensor, wshape) -> torch.Tensor:
    """Reshape per-channel params (C,) to broadcast against (..., C)."""
    if p.ndim == 0:
        return p
    return p.reshape((1,) * (len(wshape) - 1) + (p.shape[0],))


def qparams_from_range(x_min: torch.Tensor, x_max: torch.Tensor,
                       cfg: QCfg):
    """delta/zp from an explicit range via the minmax rule (the range is
    clamped to include 0)."""
    return _delta_zp_from_range(torch.clamp(x_min, max=0.0),
                                torch.clamp(x_max, min=0.0), cfg)
