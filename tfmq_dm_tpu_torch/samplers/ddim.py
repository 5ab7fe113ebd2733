"""DDIM sampler and calibration-data harvest (port of
``tfmq_dm_tpu/samplers/ddim.py``; denoising.py:10-41 of the reference).

The per-step model callback receives the step index, so FSC selects its
per-timestep activation state by step. Schedule scalars are computed on
the host in float32 with the JAX package's expressions, and the harvest
returns every model input of one rollout: O(T), not O(T^2).
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


@torch.no_grad()
def generalized_scan(model_fn: ModelFn, betas: np.ndarray, seq: np.ndarray,
                     x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     eta: float = 0.0, collect: str = "none"):
    """DDIM (generalized) sampling loop. ``collect="traj"`` also returns
    the model inputs (x_t, t) of every step, stacked. ``generator`` draws
    the noise of stochastic steps and is required when eta > 0."""
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    if eta > 0 and generator is None:
        raise ValueError("eta > 0 needs a torch.Generator")
    t_arr, at_arr, atn_arr = _step_tables(betas, seq)
    n = x.shape[0]
    one = np.float32(1.0)
    xs, ts = [], []
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
            noise = torch.randn(xt.shape, generator=generator,
                                dtype=xt.dtype, device=generator.device)
            xt_next = xt_next + float(c1) * noise.to(xt.device)
        xt_next = xt_next + float(c2) * et
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        xt = xt_next
    if collect == "none":
        return xt
    return xt, (torch.stack(xs), torch.stack(ts))


def harvest_trajectory(model_fn: ModelFn, betas: np.ndarray,
                       seq: np.ndarray, x0: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eta: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibration-data harvest: one rollout from noise, returning (xs, ts)
    with xs (steps, B, H, W, C) and ts (steps, B); index k holds the
    model input at sampling step k (data_generate.py:52-72, in O(T))."""
    _, (xs, ts) = generalized_scan(model_fn, betas, seq, x0, generator,
                                   eta=eta, collect="traj")
    return xs, ts
