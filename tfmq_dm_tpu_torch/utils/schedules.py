"""Diffusion noise schedules and timestep sequences.

The port's own copy of ``tfmq_dm_tpu/utils/schedules.py`` (it imports
nothing of the JAX package): ``get_beta_schedule``
(ddim/runners/diffusion.py:37-68) and the uniform/quad skip sequences
(ddim/runners/diffusion.py:434-447). Host-side numpy.
"""

from __future__ import annotations

import numpy as np


def get_beta_schedule(beta_schedule: str, *, beta_start: float,
                      beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1 / (np.exp(-x) + 1) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


def skip_seq(skip_type: str, num_timesteps: int,
             sample_steps: int) -> np.ndarray:
    """The subsampled timestep sequence (ascending), as in sample_image."""
    if skip_type == "uniform":
        skip = num_timesteps // sample_steps
        seq = np.arange(0, num_timesteps, skip)
    elif skip_type == "quad":
        seq = (np.linspace(0, np.sqrt(num_timesteps * 0.8),
                           sample_steps) ** 2).astype(np.int64)
    else:
        raise NotImplementedError(skip_type)
    return np.asarray(list(seq), dtype=np.int64)


def compute_alpha_bar(betas: np.ndarray) -> np.ndarray:
    """alpha_bar with the reference's index shift: a 1.0 prepended so that
    index t+1 selects cumprod up to t (denoising.py:4-7). Returned array has
    length T+1; index with (t+1)."""
    return np.concatenate([[1.0], np.cumprod(1.0 - betas)])
