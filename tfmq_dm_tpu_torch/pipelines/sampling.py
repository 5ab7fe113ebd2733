"""Batched sampling loop (port of ``sample_fid`` in
``tfmq_dm_tpu/pipelines/sampling.py``): noise -> sampler -> (first-stage
decode) -> images in [0, 1]. The caller writes them out; the PNG writer
and the FID bundle stay with the JAX package."""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.tasks import TaskConfig
from ..models import vae as vae_mod
from .ptq import latent_shape

logger = logging.getLogger(__name__)


def inverse_data_transform(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (ddim/datasets/__init__.py 'rescaled')."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


@torch.no_grad()
def sample_fid(task: TaskConfig, sampler_fn: Callable, model_fn: Callable,
               *, n_images: int, batch_size: int,
               generator: torch.Generator,
               vae_params: Optional[dict] = None, device="cuda",
               latents: Optional[list] = None) -> np.ndarray:
    """Generate ``n_images`` in batches of ``batch_size`` (the last batch
    is sampled whole and cut) -> (N, H, W, C) float32 in [0, 1]. The noise
    is drawn with ``generator`` (a CPU generator). ``latents``: a list
    that receives each batch's sampler output before decoding."""
    shape = latent_shape(task)
    out_all = []
    done = 0
    while done < n_images:
        b = min(batch_size, n_images - done)
        x0 = torch.randn((batch_size,) + shape, generator=generator)
        t0 = time.perf_counter()
        z = sampler_fn(model_fn, x0.to(device), generator)
        if latents is not None:
            latents.append(z[:b].cpu().numpy())
        out = z if vae_params is None else \
            vae_mod.decode(vae_params, task.vae, z)
        out = inverse_data_transform(out)[:b].cpu().numpy()
        logger.info("batch %d: %d images in %.3f s (%.2f imgs/s)",
                    done // batch_size, b, time.perf_counter() - t0,
                    b / (time.perf_counter() - t0))
        out_all.append(out)
        done += b
    return np.concatenate(out_all)
