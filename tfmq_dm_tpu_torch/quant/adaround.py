"""AdaRound: learned weight rounding through a hard-sigmoid relaxation
(port of ``tfmq_dm_tpu/quant/adaround.py``; the reference's
``AdaRoundQuantizer``, adaptive_rounding.py:12-74).

A per-element logit ``alpha`` decides whether each weight rounds up or
down. During reconstruction the rounding is a soft value h(alpha) in
[0, 1], so gradients flow; at inference it hardens to (alpha >= 0).

The clips take ``jnp.clip``'s gradient: an element exactly on a bound
passes half the gradient (``torch.clamp`` passes all of it).
"""

from __future__ import annotations

import torch

from .quantizer import QCfg, broadcast_channel

GAMMA, ZETA = -0.1, 1.1


class _Clip(torch.autograd.Function):
    """clamp(x, lo, hi) with ``jnp.clip``'s gradient, which is that of
    min(max(x, lo), hi) with ties split: 1 inside, 1/2 on a bound, 0
    outside."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > ctx.lo) & (x < ctx.hi)).to(g.dtype)
        tie = ((x == ctx.lo) | (x == ctx.hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return _Clip.apply(x, lo, hi)


def init_alpha(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """alpha such that h(alpha) is the fractional part of w / delta
    (adaptive_rounding.py:31-38)."""
    delta = broadcast_channel(delta, w.shape)
    scaled = w * (1.0 / delta)
    rest = torch.clamp(scaled - torch.floor(scaled), 1e-4, 1.0 - 1e-4)
    # a tensor numerator: ``scalar / tensor`` is a reciprocal and a
    # product in PyTorch, rounded twice
    span = torch.tensor(ZETA - GAMMA, dtype=w.dtype, device=w.device)
    return -torch.log(span / (rest - GAMMA) - 1.0)


def soft_targets(alpha: torch.Tensor) -> torch.Tensor:
    """h(alpha) = clip(sigmoid(alpha) (zeta - gamma) + gamma, 0, 1)
    (adaptive_rounding.py:40-41)."""
    return _clip(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def adaround_fq(w: torch.Tensor, delta: torch.Tensor,
                zero_point: torch.Tensor, alpha: torch.Tensor, cfg: QCfg,
                soft: bool) -> torch.Tensor:
    """Quantize-dequantize a weight with AdaRound rounding
    (adaptive_rounding.py:43-71): soft (h(alpha)) or hard (alpha >= 0).
    The clamp ignores ``always_zero`` (weights never use it)."""
    delta = broadcast_channel(delta, w.shape)
    zero_point = broadcast_channel(zero_point, w.shape)
    w_floor = torch.floor(w * (1.0 / delta))
    if soft:
        w_int = w_floor + soft_targets(alpha)
    else:
        w_int = w_floor + (alpha >= 0).to(w.dtype)
    nb = -cfg.level // 2 if cfg.symmetric else 0
    pb = cfg.level // 2 - 1 if cfg.symmetric else cfg.level - 1
    w_q = _clip(w_int + zero_point, float(nb), float(pb))
    return delta * (w_q - zero_point)


def round_regularizer(alpha: torch.Tensor, b) -> torch.Tensor:
    """f_reg = sum(1 - |2h - 1|^b): pushes h to {0, 1} as the temperature
    b (a float32 value, tensor or float) decays
    (reconstruction_util.py:72-73)."""
    h = soft_targets(alpha)
    return torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** b)


def linear_temp_decay(t: torch.Tensor, t_max: int, rel_start_decay: float,
                      start_b: float = 20.0,
                      end_b: float = 2.0) -> torch.Tensor:
    """Temperature schedule (reconstruction_util.py:176-198): start_b until
    rel_start_decay * t_max, then linear to end_b. ``t``: a float32
    tensor; the constants are float32, as JAX's weak types make them."""
    f32 = dict(dtype=torch.float32, device=t.device)
    start_decay = torch.tensor(rel_start_decay * t_max, **f32)
    span = torch.tensor(max(t_max - rel_start_decay * t_max, 1e-9), **f32)
    rel_t = (t - start_decay) / span
    decayed = end_b + (start_b - end_b) * torch.clamp(1.0 - rel_t, min=0.0)
    return torch.where(t < start_decay, torch.tensor(start_b, **f32),
                       decayed)
