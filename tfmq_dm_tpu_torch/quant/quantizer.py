"""Uniform affine quantization primitives (PyTorch port of
``tfmq_dm_tpu/quant/quantizer.py``).

Same conventions as the JAX package: per-channel weight quantization runs
over the LAST axis of the weight (HWIO convs, (in, out) linears), and
quantizer params are plain tensors ``delta`` / ``zero_point``.

The arithmetic follows the JAX code operation for operation, in float32,
so that integer codes and (delta, zero_point) come out bit-equal:
quantize as ``x * (1.0 / delta)`` (never ``x / delta``), round half to
even (``torch.round``, like ``jnp.round``). ``fake_quant`` takes the JAX
package's gradient, straight through the rounding (``ste_round``'s) and
``jnp.clip``'s at the clamp, so that the act phase can train the
activation deltas. The range scalers are minmax, mse, and the KL and
histogram searches, which run in float64 numpy on the host as in the JAX
package. The reconstruction losses and the running-stat (EMA) range
update are here too.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
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


def _clip_grad(g: torch.Tensor, v: torch.Tensor, lo: float,
               hi: float) -> torch.Tensor:
    """The gradient of ``jnp.clip(v, lo, hi)``, that of min(max(v, lo), hi)
    with ties split: 1 inside, 1/2 on a bound, 0 outside."""
    inside = ((v > lo) & (v < hi)).to(g.dtype)
    tie = ((v == lo) | (v == hi)).to(g.dtype)
    return g * (inside + 0.5 * tie)


class _Clip(torch.autograd.Function):
    """torch.clamp with ``jnp.clip``'s gradient."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _clip_grad(g, x, ctx.lo, ctx.hi), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: torch.clamp's values, jnp.clip's
    gradient."""
    return _Clip.apply(x, lo, hi)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (quant_layer.py:159-160).
    ``round(x) - x`` is exact in float32 (both are multiples of x's ulp
    and at most 1/2 apart), so the value is ``round(x)`` bit for bit."""
    return x + (torch.round(x) - x).detach()


def _codes(x: torch.Tensor, delta: torch.Tensor, zero_point, nb: int,
           pb: int) -> torch.Tensor:
    """clamp(round(x * (1 / delta)) + zero_point, nb, pb): the integer
    codes (as floats) of every quantize path."""
    return torch.clamp(torch.round(x * (1.0 / delta)) + zero_point, nb, pb)


class _QuantCodes(torch.autograd.Function):
    """``_codes`` with the gradient of JAX's ``jnp.clip(ste_round(x *
    (1.0 / delta)) + zero_point, nb, pb)``: the rounding passes it
    straight through, the clip as ``clip``; none to the zero point, which
    nothing trains."""

    @staticmethod
    def forward(ctx, x, delta, zero_point, nb: int, pb: int):
        ctx.save_for_backward(x, delta, torch.as_tensor(zero_point))
        ctx.nb, ctx.pb = nb, pb
        return _codes(x, delta, zero_point, nb, pb)

    @staticmethod
    def backward(ctx, g):
        x, delta, zero_point = ctx.saved_tensors
        inv = 1.0 / delta
        gv = _clip_grad(g, torch.round(x * inv) + zero_point, ctx.nb,
                        ctx.pb)
        gx = gv * inv if ctx.needs_input_grad[0] else None
        # d (x * (1 / delta)) / d delta = -x / delta^2, as autograd takes
        # it through the reciprocal
        gd = -(gv * x).sum_to_size(delta.shape) * (inv * inv) \
            if ctx.needs_input_grad[1] else None
        return gx, gd, None, None, None


def fake_quant(x: torch.Tensor, delta: torch.Tensor,
               zero_point: torch.Tensor, cfg: QCfg) -> torch.Tensor:
    """Quantize-dequantize (quant_layer.py:223-227); keeps x's dtype, with
    the q/dq arithmetic in the promoted precision (f32 for bf16 x). Where
    a gradient is wanted the codes take ``_QuantCodes``' (the JAX
    package's straight-through one); the values are ``_codes``' either
    way."""
    nb, pb = cfg.qrange
    xp = _promote(x, delta)
    if torch.is_grad_enabled() and (xp.requires_grad
                                    or delta.requires_grad):
        x_q = _QuantCodes.apply(xp, delta, zero_point, nb, pb)
    else:
        x_q = _codes(xp, delta, zero_point, nb, pb)
    return (delta * (x_q - zero_point)).to(x.dtype)


def quant_int(x: torch.Tensor, delta: torch.Tensor,
              zero_point: torch.Tensor, cfg: QCfg,
              dtype=torch.int8) -> torch.Tensor:
    """Integer codes (no dequant)."""
    nb, pb = cfg.qrange
    return _codes(_promote(x, delta), delta, zero_point, nb, pb).to(dtype)


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
    the JAX ``fori_loop``. The candidates' grids are computed together
    (elementwise: each is the grid of its step bit for bit), then each
    one's score over x; the pick is the first least score, where a NaN
    score never wins and a NaN first score keeps the first grid, as the
    loop's ``s < best`` does."""
    nb, pb = cfg.qrange
    step = torch.tensor(0.01, dtype=torch.float32, device=x.device)
    shrink = 1.0 - torch.arange(num_steps, dtype=torch.float32,
                                device=x.device)[:, None] * step
    deltas, zps = _delta_zp_from_range(x.amin(dim=1) * shrink,
                                       x.amax(dim=1) * shrink, cfg)
    scores = []
    for i in range(num_steps):
        d, z = deltas[i, :, None], zps[i, :, None]
        x_q = _codes(x, d, z, nb, pb)
        scores.append(torch.mean(torch.abs(d * (x_q - z) - x) ** p, dim=1))
    scores = torch.stack(scores)
    best = torch.argmin(torch.where(torch.isnan(scores), torch.inf, scores),
                        dim=0)
    best = torch.where(torch.isnan(scores[0]), 0, best)[None]
    return deltas.gather(0, best)[0], zps.gather(0, best)[0]


def _kl_clipped(np_x: np.ndarray, level: int) -> np.ndarray:
    """The histogram-KL clip search of one row (quant_layer.py:67-110):
    the clip ratio in linspace(0.5, 1, 50) whose clipped histogram,
    resampled onto the reference bins, is nearest the data's in KL; the
    row clipped at it. float64, as the JAX package's host numpy."""
    ref_hist, ref_bins = np.histogram(np_x, bins=level, density=True)
    sumd = np.sum(np.diff(ref_bins))
    smooth_ref = (ref_hist + 1e-5) / (1.0 + sumd * 1e-5)

    def resample(targ_hist, targ_bins, orig_bins):
        targ_v, targ_i = 0.0, 0
        targ_bin = targ_bins[0]
        out = np.zeros(len(orig_bins) - 1)
        for i, orig_bin in enumerate(orig_bins[:-1]):
            if targ_bin <= orig_bin:
                if targ_i < len(targ_bins) - 1:
                    targ_v = targ_hist[targ_i]
                    targ_i += 1
                    targ_bin = targ_bins[targ_i]
                else:
                    targ_v = 0.0
                    targ_bin = orig_bin.max() + 1.0
            out[i] = targ_v
        return out

    min_kl, best_ratio = 1e5, 1.0
    for clip_ratio in np.linspace(0.5, 1.0, 50):
        lo, hi = np_x.min() * clip_ratio, np_x.max() * clip_ratio
        q_hist, q_bins = np.histogram(np.clip(np_x, lo, hi), bins=level,
                                      density=True)
        c_q = resample(q_hist, q_bins, ref_bins)
        c_q = (c_q + 1e-5) / (1.0 + sumd * 1e-5)
        kl_val = float(np.sum(smooth_ref * np.log(smooth_ref / c_q)))
        if kl_val < min_kl:
            min_kl, best_ratio = kl_val, clip_ratio
    return np.clip(np_x, np_x.min() * best_ratio, np_x.max() * best_ratio)


def _hist_clipped(np_x: np.ndarray, level: int,
                  threshold: float) -> np.ndarray:
    """The percentile-mass clip of one row (quant_layer.py:113-133): the
    first bin of |x|'s histogram at which the mass reaches
    ``threshold``."""
    data_max = max(-np_x.min(), np_x.max())
    h, _ = np.histogram(np_x, bins=level, range=(0, data_max), density=True)
    h = h.astype(np.float64) / h.sum()
    accum = 0.0
    x_min, x_max = np_x.min(), np_x.max()
    for i in range(len(h)):
        accum += h[i]
        if accum >= threshold:
            clip_value = (i + 0.5) * (data_max / level)
            x_min = max(-clip_value, np_x.min())
            x_max = min(clip_value, np_x.max())
            break
    return np.clip(np_x, x_min, x_max)


def _minmax_of_clipped(x: torch.Tensor, clip_row, cfg: QCfg):
    """minmax of each row clipped on the host in float64, back in
    float32 on x's device."""
    rows = x.detach().to("cpu", torch.float64).numpy()
    clipped = np.stack([clip_row(r) for r in rows]).astype(np.float32)
    return scaler_minmax(torch.from_numpy(clipped).to(x.device), cfg)


def scaler_kl(x: torch.Tensor, cfg: QCfg, bins: int | None = None):
    """Histogram-KL clip, then minmax (quant_layer.py:67-110); calibration
    time only, on the host."""
    return _minmax_of_clipped(
        x, lambda r: _kl_clipped(r, bins or cfg.level), cfg)


def scaler_hist(x: torch.Tensor, cfg: QCfg, threshold: float = 0.9996):
    """Percentile-mass clip, then minmax (quant_layer.py:113-133);
    calibration time only, on the host."""
    return _minmax_of_clipped(
        x, lambda r: _hist_clipped(r, cfg.level, threshold), cfg)


SCALERS = {"minmax": scaler_minmax, "mse": scaler_mse, "kl": scaler_kl,
           "hist": scaler_hist}


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


def ema_range_update(x: torch.Tensor, x_min: torch.Tensor,
                     x_max: torch.Tensor, momentum: float = 0.95):
    """Running-stat EMA of an activation range (quant_layer.py:229-244)."""
    new_min = x_min * momentum + torch.min(x) * (1.0 - momentum)
    new_max = x_max * momentum + torch.max(x) * (1.0 - momentum)
    return new_min, new_max


def lp_loss(pred: torch.Tensor, tgt: torch.Tensor, p: float = 2.0,
            channel_axis: int = -1) -> torch.Tensor:
    """|pred - tgt|^p summed over the channel axis (the last: tensors are
    channel-last), averaged over the rest (quant_layer.py:146-156)."""
    return torch.mean(torch.sum(torch.abs(pred - tgt) ** p,
                                dim=channel_axis))


def lp_loss_all(pred: torch.Tensor, tgt: torch.Tensor,
                p: float = 2.0) -> torch.Tensor:
    return torch.mean(torch.abs(pred - tgt) ** p)
