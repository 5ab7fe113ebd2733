"""QuantCtx — threaded through a model's ``apply``; every quantizable call
site consults it (port of ``tfmq_dm_tpu/quant/context.py``).

It carries the static ``policy``, the weight state ``wstate`` ({layer:
{"delta","zp"[, "alpha"]}}), the per-step activation state ``astate``
({site: {"delta","zp"}}), the mode flags ``use_wq`` / ``use_aq``, and:

- ``act_mode="init"``: each activation site computes fresh (delta, zp)
  from the current batch, in forward order, and records them in
  ``out_astate`` (the FSC init pass, fsc.py:30-38);
- ``deploy``: {layer: deployed weight} — the call sites execute the
  deployed integer weights (quant/deploy.py) instead of fake-quant;
- ``act_out_dtype``: the carrier dtype of deployed layers' outputs
  (None: the input's; bfloat16: the fast deploy, ``--deploy_dtype
  bfloat16``);
- ``flash``: opt in to the flash-attention kernels (inference contexts;
  see ``ops/attention.py``);
- ``shape_tape``: when a dict, deployed int8 conv sites record their
  geometry {layer: (in_hw, stride, pads)} (``deploy.specialize_maps``);
- ``capture``: the reconstruction tape's unit set; None here (the tape
  belongs to the calibration slice), and the flash dispatch requires it.

The EMA pass belongs to the calibration slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .policy import QuantPolicy
from .quantizer import QCfg, broadcast_channel, fake_quant, init_qparams


def adaround_hard_fq(w: torch.Tensor, delta: torch.Tensor,
                     zero_point: torch.Tensor, alpha: torch.Tensor,
                     cfg: QCfg) -> torch.Tensor:
    """AdaRound fake-quant with hardened rounding (alpha >= 0 rounds up),
    adaptive_rounding.py:43-71; the clamp ignores ``always_zero``."""
    delta = broadcast_channel(delta, w.shape)
    zero_point = broadcast_channel(zero_point, w.shape)
    w_int = torch.floor(w * (1.0 / delta)) + (alpha >= 0).to(w.dtype)
    nb = -cfg.level // 2 if cfg.symmetric else 0
    pb = cfg.level // 2 - 1 if cfg.symmetric else cfg.level - 1
    w_q = torch.clamp(w_int + zero_point, nb, pb)
    return delta * (w_q - zero_point)


class QuantCtx:
    def __init__(self,
                 policy: QuantPolicy,
                 wstate: Optional[dict] = None,
                 astate: Optional[dict] = None,
                 use_wq: bool = False,
                 use_aq: bool = False,
                 act_mode: Optional[str] = None,  # None | "init"
                 act_scaler: str = "mse",
                 deploy: Optional[dict] = None,
                 act_out_dtype: Optional[torch.dtype] = None,
                 flash: bool = False):
        if act_mode not in (None, "init"):
            raise ValueError(f"act_mode {act_mode!r}: only None or 'init'")
        self.policy = policy
        self.wstate = wstate or {}
        self.astate = astate or {}
        self.use_wq = use_wq
        self.use_aq = use_aq
        self.act_mode = act_mode
        self.act_scaler = act_scaler
        self.out_astate: Dict[str, dict] = {}
        self.deploy = deploy
        self.act_out_dtype = act_out_dtype
        self.flash = flash
        self.shape_tape: Optional[dict] = None
        self.capture = None

    def qweight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        if not self.use_wq:
            return w
        pol = self.policy.get(name)
        if pol is None or not pol.wq:
            return w
        st = self.wstate.get(name)
        if st is None:
            return w
        if "alpha" in st:
            return adaround_hard_fq(w, st["delta"], st["zp"], st["alpha"],
                                    pol.w_cfg)
        delta = broadcast_channel(st["delta"], w.shape)
        zp = broadcast_channel(st["zp"], w.shape)
        return fake_quant(w, delta, zp, pol.w_cfg)

    def qact(self, name: str, x: torch.Tensor) -> torch.Tensor:
        pol = self.policy.get(name)
        if pol is None or not pol.aq or not self.use_aq:
            return x
        cfg: QCfg = pol.a_cfg
        if self.act_mode == "init":
            delta, zp = init_qparams(x, cfg, scaler=self.act_scaler)
            self.out_astate[name] = {"delta": delta, "zp": zp}
            return fake_quant(x, delta, zp, cfg)
        st = self.astate.get(name)
        if st is None:
            return x
        return fake_quant(x, st["delta"], st["zp"], cfg)
