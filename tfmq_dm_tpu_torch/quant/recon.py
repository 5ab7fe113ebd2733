"""Weight-quantizer initialization (port of ``init_weight_qparams`` in
``tfmq_dm_tpu/quant/recon.py``). The reconstruction engine (AdaRound,
TIAR) waits for the calibration slice."""

from __future__ import annotations

from typing import Dict

import torch

from .quantizer import init_qparams


@torch.no_grad()
def init_weight_qparams(policy, params, scaler: str = "mse") -> Dict:
    """Per-channel (delta, zp) for every wq-enabled layer, from the weight
    tensor itself (the reference's dummy init forward,
    calibration.py:87-92)."""
    wstate = {}
    for name in policy.weight_layers():
        pol = policy.get(name)
        if not pol.wq:
            continue
        delta, zp = init_qparams(params[name]["w"], pol.w_cfg, scaler=scaler)
        wstate[name] = {"delta": delta, "zp": zp}
    return wstate
