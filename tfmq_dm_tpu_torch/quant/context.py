"""QuantCtx — threaded through a model's ``apply``; every quantizable call
site consults it (port of ``tfmq_dm_tpu/quant/context.py``).

It carries the static ``policy``, the weight state ``wstate`` ({layer:
{"delta","zp"[, "alpha"]}}), the per-step activation state ``astate``
({site: {"delta","zp"}}), the mode flags ``use_wq`` / ``use_aq`` (weights
with AdaRound alphas round hard here; the reconstruction's soft rounding
goes through the unit forwards, models/ddim_units.py), and:

- ``act_mode="init"``: each activation site computes fresh (delta, zp)
  from the current batch, in forward order, into ``out_astate``, and
  seeds the EMA range with the batch's min/max in ``out_arange`` (the FSC
  init pass, fsc.py:30-38);
- ``act_mode="ema"``: each site updates its range from ``arange`` with
  momentum ``ema_momentum`` and quantizes with the grid of the updated
  range (the running-stat pass, quant_layer.py:229-244);
- ``capture`` / ``capture_tags``: the reconstruction tape. Models call
  ``tap(unit, "in"|"out", value)`` at unit boundaries; a listed unit's
  values land in ``tape["<unit>::<tag>"]``. ``stop_when_taped`` ends the
  forward (``CaptureDone``) once every listed unit's listed tags are on
  the tape, the reference's StopForwardException (data_utill.py:76-169);
- ``override``: {unit: value} — an "out" tap of a listed unit returns
  ``value`` in place of the unit's output, and the forward runs on from
  it (the Fisher gradients, ``recon.capture_unit_grads``: d loss / d
  unit output, the reference's backward hooks, data_utill.py:172-256);
- ``deploy``: {layer: deployed weight} — the call sites execute the
  deployed integer weights (quant/deploy.py) instead of fake-quant;
- ``act_out_dtype``: the carrier dtype of deployed layers' outputs
  (None: the input's; bfloat16: the fast deploy, ``--deploy_dtype
  bfloat16``);
- ``flash``: opt in to the flash-attention kernels (inference contexts;
  see ``ops/attention.py``, which also keeps flash off under a tape);
- ``shape_tape``: when a dict, deployed int8 conv sites record their
  geometry {layer: (in_hw, stride, pads)} (``deploy.specialize_maps``).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional

import torch

from .adaround import adaround_fq
from .policy import QuantPolicy
from .quantizer import (QCfg, broadcast_channel, ema_range_update,
                        fake_quant, init_qparams, qparams_from_range)


class CaptureDone(Exception):
    """Raised by ``QuantCtx.tap`` when the tape holds all it was asked
    for and ``stop_when_taped`` is set: the rest of the forward is not
    needed."""


class QuantCtx:
    def __init__(self,
                 policy: QuantPolicy,
                 wstate: Optional[dict] = None,
                 astate: Optional[dict] = None,
                 use_wq: bool = False,
                 use_aq: bool = False,
                 capture: Optional[FrozenSet[str]] = None,
                 act_mode: Optional[str] = None,  # None | "init" | "ema"
                 arange: Optional[dict] = None,
                 act_scaler: str = "mse",
                 ema_momentum: float = 0.95,
                 deploy: Optional[dict] = None,
                 act_out_dtype: Optional[torch.dtype] = None,
                 override: Optional[dict] = None,
                 flash: bool = False,
                 capture_tags: Optional[FrozenSet[str]] = None,
                 stop_when_taped: bool = False):
        if act_mode not in (None, "init", "ema"):
            raise ValueError(f"act_mode {act_mode!r}: None, 'init' or "
                             "'ema'")
        self.policy = policy
        self.wstate = wstate or {}
        self.astate = astate or {}
        self.use_wq = use_wq
        self.use_aq = use_aq
        # None: no tape; else a set of unit names (or {"*"})
        self.capture = capture
        # None: tape both "in" and "out"; else only the listed tags
        self.capture_tags = capture_tags
        self.tape: Dict[str, object] = {}
        self.override = override
        self._stop_keys = None
        # an override pass runs the forward on from the unit to the end
        if stop_when_taped and capture is not None and \
                "*" not in capture and override is None:
            tags = capture_tags or frozenset({"in", "out"})
            self._stop_keys = {f"{u}::{t}" for u in capture for t in tags}
        self.act_mode = act_mode
        self.arange = arange or {}
        self.act_scaler = act_scaler
        self.ema_momentum = ema_momentum
        self.out_astate: Dict[str, dict] = {}
        self.out_arange: Dict[str, tuple] = {}
        self.deploy = deploy
        self.act_out_dtype = act_out_dtype
        self.flash = flash
        self.shape_tape: Optional[dict] = None

    # ---------------- weight path ----------------

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
            return adaround_fq(w, st["delta"], st["zp"], st["alpha"],
                               pol.w_cfg, soft=False)
        delta = broadcast_channel(st["delta"], w.shape)
        zp = broadcast_channel(st["zp"], w.shape)
        return fake_quant(w, delta, zp, pol.w_cfg)

    # ---------------- activation path ----------------

    def qact(self, name: str, x: torch.Tensor) -> torch.Tensor:
        pol = self.policy.get(name)
        if pol is None or not pol.aq or not self.use_aq:
            return x
        cfg: QCfg = pol.a_cfg
        if self.act_mode == "init":
            delta, zp = init_qparams(x, cfg, scaler=self.act_scaler)
            self.out_astate[name] = {"delta": delta, "zp": zp}
            # the EMA range starts at the raw batch min/max, as the
            # reference's leaf_param init (quant_layer.py:206-207)
            self.out_arange[name] = (torch.min(x), torch.max(x))
            return fake_quant(x, delta, zp, cfg)
        if self.act_mode == "ema":
            x_min, x_max = self.arange[name]
            x_min, x_max = ema_range_update(x, x_min, x_max,
                                            self.ema_momentum)
            delta, zp = qparams_from_range(x_min, x_max, cfg)
            self.out_arange[name] = (x_min, x_max)
            self.out_astate[name] = {"delta": delta, "zp": zp}
            return fake_quant(x, delta, zp, cfg)
        st = self.astate.get(name)
        if st is None:
            return x
        return fake_quant(x, st["delta"], st["zp"], cfg)

    # ---------------- capture tape ----------------

    def tap(self, unit: str, tag: str, value):
        """Record a unit-boundary value when ``unit`` and ``tag`` are
        captured; returns the value that flows on: ``override[unit]`` for
        an "out" tag of an overridden unit, else ``value``."""
        if self.override is not None and tag == "out" and \
                unit in self.override:
            value = self.override[unit]
        if self.capture is not None and \
                ("*" in self.capture or unit in self.capture) and \
                (self.capture_tags is None or tag in self.capture_tags):
            self.tape[f"{unit}::{tag}"] = value
            if self._stop_keys is not None and \
                    self._stop_keys.issubset(self.tape):
                raise CaptureDone
        return value

