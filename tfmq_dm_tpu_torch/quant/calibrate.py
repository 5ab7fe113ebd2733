"""Calibration orchestrator (port of ``tfmq_dm_tpu/quant/calibrate.py``):

  1. weight-quantizer init (per-channel, on the weights themselves);
  2. TIAR reconstruction, unit by unit in module order (TIB first);
  3. FSC per-timestep activation calibration;
  4. artifact save;

and ``load_cali_model``. ``hp=None`` skips reconstruction: weight grids
and FSC only, the nearest-rounding artifact.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch

from ..ops.nn import exact_f32
from .adapter import ModelAdapter
from .artifact import load_artifact, save_artifact
from .fsc import fsc_calibrate
from .recon import ReconHP, init_weight_qparams, reconstruct

logger = logging.getLogger(__name__)


def cali_model(adapter: ModelAdapter, params,
               w_cali_data: Optional[Tuple[torch.Tensor, ...]] = None,
               a_cali_data: Optional[Tuple[torch.Tensor, ...]] = None, *,
               hp: Optional[ReconHP] = ReconHP(), use_aq: bool = False,
               running_stat: bool = True, path: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               w_scaler: str = "mse", act_scaler: str = "mse",
               init_samples: int = 16, meta: Optional[dict] = None,
               capture_batch_size: int = 128,
               resume_dir: Optional[str] = None,
               recon_stats: Optional[dict] = None
               ) -> Tuple[Dict, Optional[Dict]]:
    """Full PTQ calibration. ``w_cali_data``: sample-major tuple (x, t)
    for reconstruction; ``a_cali_data``: group-major tuple (G, N, ...)
    for FSC (needed when ``use_aq``). Returns (wstate, astate).

    ``generator`` (a CPU generator; seed 0 when None) seeds the
    reconstruction with one draw, then draws FSC's subsets.
    ``recon_stats`` collects each unit's record: its first and last
    reconstruction loss and the guard's record (``recon.reconstruct_unit``),
    also for units resumed from ``resume_dir``. With reconstruction the
    artifact's meta holds the same records under "recon". TF32 is off for
    the whole calibration (``ops.nn.exact_f32``)."""
    exact_f32()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    logger.info("calibrating: weight qparam init (%s)", w_scaler)
    wstate = init_weight_qparams(adapter.policy, params, scaler=w_scaler)

    if hp is not None:
        if w_cali_data is None:
            raise ValueError("reconstruction needs w_cali_data")
        stats = recon_stats if recon_stats is not None else {}

        def _log(unit, trace):
            if trace is None:
                logger.info("recon %-24s resumed from checkpoint", unit)
            else:
                logger.info("recon %-24s loss %.6f -> %.6f", unit,
                            stats[unit]["loss_first"],
                            stats[unit]["loss_last"])

        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        logger.info("calibrating: TIAR reconstruction over %d units",
                    len(adapter.units))
        wstate = reconstruct(adapter, params, w_cali_data, wstate, hp,
                             torch.Generator().manual_seed(seed),
                             capture_batch_size=capture_batch_size,
                             log=_log, resume_dir=resume_dir, stats=stats)
        meta = dict(meta or {})
        meta["recon"] = {"iters": hp.iters, "units": dict(stats)}

    astate = None
    if use_aq:
        if a_cali_data is None:
            raise ValueError("use_aq needs a_cali_data")
        logger.info("calibrating: FSC over %d timestep groups",
                    a_cali_data[0].shape[0])
        astate = fsc_calibrate(adapter, params, wstate, a_cali_data,
                               generator, running_stat=running_stat,
                               init_samples=init_samples,
                               act_scaler=act_scaler)
    if path:
        save_artifact(path, wstate, astate, meta)
        logger.info("calibration artifact saved to %s", path)
    return wstate, astate


def load_cali_model(path: str, device="cuda"
                    ) -> Tuple[Dict, Optional[Dict], dict]:
    """Load a calibration artifact -> (wstate, astate, meta)."""
    return load_artifact(path, device=device)
