"""Calibration entry points (port of the parts of
``tfmq_dm_tpu/quant/calibrate.py`` this slice uses): weight-grid init +
FSC init pass + artifact save, and ``load_cali_model``. TIAR
reconstruction waits for the calibration slice."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .adapter import ModelAdapter
from .artifact import load_artifact, save_artifact
from .fsc import fsc_calibrate
from .recon import init_weight_qparams


def cali_model(adapter: ModelAdapter, params,
               a_cali_data: Tuple[torch.Tensor, ...],
               generator: Optional[torch.Generator] = None, *,
               path: Optional[str] = None, w_scaler: str = "mse",
               act_scaler: str = "mse", init_samples: int = 16,
               meta: Optional[dict] = None) -> Tuple[Dict, Dict]:
    """Weight grids from the weights, then the FSC init pass over the
    group-major ``a_cali_data``; saves the artifact when ``path`` is
    given. Returns (wstate, astate)."""
    wstate = init_weight_qparams(adapter.policy, params, scaler=w_scaler)
    astate = fsc_calibrate(adapter, params, wstate, a_cali_data, generator,
                           init_samples=init_samples,
                           act_scaler=act_scaler)
    if path:
        save_artifact(path, wstate, astate, meta)
    return wstate, astate


def load_cali_model(path: str, device="cuda"
                    ) -> Tuple[Dict, Optional[Dict], dict]:
    """Load a calibration artifact -> (wstate, astate, meta)."""
    return load_artifact(path, device=device)
