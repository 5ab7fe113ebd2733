"""DDIM and DDPM samplers and the calibration-data harvest (port of
``tfmq_dm_tpu/samplers/ddim.py``; denoising.py:10-88 of the reference).

The per-step model callback receives the step index, so FSC selects its
per-timestep activation state by step. Schedule scalars are computed on
the host in float32 with the JAX package's expressions, and the harvest
returns every model input of one rollout: O(T), not O(T^2). Stochastic
steps draw their unit normals from a ``torch.Generator``, one step at a
time, or read them from ``noise``, a (steps, N, H, W, C) tensor (step
i's at ``noise[i]``; JAX draws it from ``fold_in(key, i)``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.schedules import compute_alpha_bar

# model_fn(x, t_batch, step_index) -> eps
ModelFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def _step_tables(betas: np.ndarray, seq: np.ndarray):
    """Per-step (t, at, at_next) in sampling order (reversed seq),
    denoising.py:14-22, as float32 like the JAX tables."""
    ab = compute_alpha_bar(betas)
    seq = np.asarray(seq, dtype=np.int64)
    seq_next = np.concatenate([[-1], seq[:-1]])
    t_arr = seq[::-1].copy()
    tn_arr = seq_next[::-1].copy()
    return (t_arr.astype(np.int32), ab[t_arr + 1].astype(np.float32),
            ab[tn_arr + 1].astype(np.float32))


def step_noise(noise, generator, i, like: torch.Tensor) -> torch.Tensor:
    """Step i's unit normals: ``noise[i]``, or a draw of ``generator``."""
    z = noise[i] if noise is not None else torch.randn(
        like.shape, generator=generator, dtype=like.dtype,
        device=generator.device)
    return z.to(like.device, like.dtype)


def check_noise(noise, steps: int, x: torch.Tensor) -> None:
    if noise is not None and tuple(noise.shape) != \
            (steps,) + tuple(x.shape):
        raise ValueError(f"noise {tuple(noise.shape)}: expected "
                         f"{(steps,) + tuple(x.shape)}")


def _collected(xt, collect: str, xs, ts, x0s):
    if collect == "none":
        return xt
    if collect == "x0":
        return xt, torch.stack(x0s)
    return xt, (torch.stack(xs), torch.stack(ts))


@torch.no_grad()
def generalized_scan(model_fn: ModelFn, betas: np.ndarray, seq: np.ndarray,
                     x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     eta: float = 0.0, collect: str = "none",
                     noise: Optional[torch.Tensor] = None):
    """DDIM (generalized) sampling loop. ``collect="traj"`` also returns
    the model inputs (x_t, t) of every step, stacked; ``collect="x0"``
    each step's x0 prediction, stacked. The noise of stochastic steps (eta
    > 0) is drawn with ``generator`` or read from ``noise``."""
    if collect not in ("none", "traj", "x0"):
        raise ValueError(f"collect must be 'none', 'traj' or 'x0', got "
                         f"{collect!r}")
    t_arr, at_arr, atn_arr = _step_tables(betas, seq)
    check_noise(noise, len(t_arr), x)
    if eta > 0 and generator is None and noise is None:
        raise ValueError("eta > 0 needs a torch.Generator or the noise")
    n = x.shape[0]
    one = np.float32(1.0)
    xs, ts, x0s = [], [], []
    xt = x
    for i in range(len(t_arr)):
        at, at_next = at_arr[i], atn_arr[i]
        t_b = torch.full((n,), int(t_arr[i]), dtype=torch.int32,
                         device=x.device)
        # a bf16 eps (the fast deploy) meets the f32 step scalars in f32,
        # as JAX promotes it
        et = model_fn(xt, t_b, i)
        et = et.to(torch.promote_types(et.dtype, xt.dtype))
        x0_t = (xt - et * float(np.sqrt(one - at))) / float(np.sqrt(at))
        c1 = np.float32(eta) * np.sqrt((one - at / at_next)
                                       * (one - at_next) / (one - at))
        c2 = np.sqrt(np.maximum((one - at_next) - c1 ** 2, np.float32(0)))
        xt_next = float(np.sqrt(at_next)) * x0_t
        if eta > 0:
            xt_next = xt_next + float(c1) * step_noise(noise, generator,
                                                        i, xt)
        xt_next = xt_next + float(c2) * et
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        elif collect == "x0":
            x0s.append(x0_t)
        xt = xt_next
    return _collected(xt, collect, xs, ts, x0s)


@torch.no_grad()
def ddpm_scan(model_fn: ModelFn, betas: np.ndarray, seq: np.ndarray,
              x: torch.Tensor, generator: Optional[torch.Generator] = None,
              collect: str = "none",
              noise: Optional[torch.Tensor] = None):
    """DDPM (noisy) sampling loop (denoising.py:44-88; ddim.py:97-128):
    the fixed-large variance log(beta_t), beta_t = 1 - at / at_prev; x0
    clipped to [-1, 1]; no noise at t == 0. Every other step adds noise,
    drawn with ``generator`` or read from ``noise``. ``collect="traj"``
    also returns the model inputs (x_t, t) of every step, stacked."""
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    t_arr, at_arr, atm1_arr = _step_tables(betas, seq)
    check_noise(noise, len(t_arr), x)
    if generator is None and noise is None:
        raise ValueError("DDPM steps need a torch.Generator or the noise")
    n = x.shape[0]
    one = np.float32(1.0)
    xs, ts = [], []
    xt = x
    for i in range(len(t_arr)):
        at, atm1 = at_arr[i], atm1_arr[i]
        beta_t = one - at / atm1
        t_b = torch.full((n,), int(t_arr[i]), dtype=torch.int32,
                         device=x.device)
        e = model_fn(xt, t_b, i)
        e = e.to(torch.promote_types(e.dtype, xt.dtype))
        x0 = float(np.sqrt(one / at)) * xt - \
            float(np.sqrt(one / at - one)) * e
        x0 = torch.clamp(x0, -1.0, 1.0)
        mean = (float(np.sqrt(atm1) * beta_t) * x0
                + float(np.sqrt(one - beta_t) * (one - atm1)) * xt) \
            / float(one - at)
        if t_arr[i] != 0:
            mean = mean + float(np.exp(np.float32(0.5) * np.log(beta_t))) \
                * step_noise(noise, generator, i, xt)
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        xt = mean
    return _collected(xt, collect, xs, ts, None)


def harvest_trajectory(model_fn: ModelFn, betas: np.ndarray,
                       seq: np.ndarray, x0: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eta: float = 0.0, sample_type: str = "generalized",
                       noise: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibration-data harvest: one rollout from noise, returning (xs, ts)
    with xs (steps, B, H, W, C) and ts (steps, B); index k holds the
    model input at sampling step k (data_generate.py:52-72, in O(T)).
    ``sample_type``: "generalized" (DDIM at ``eta``) or "ddpm_noisy"."""
    if sample_type == "generalized":
        _, (xs, ts) = generalized_scan(model_fn, betas, seq, x0, generator,
                                       eta=eta, collect="traj", noise=noise)
    else:
        _, (xs, ts) = ddpm_scan(model_fn, betas, seq, x0, generator,
                                collect="traj", noise=noise)
    return xs, ts
