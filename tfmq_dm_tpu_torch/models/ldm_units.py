"""LDM UNet adapter (port of ``build_adapter`` in
``tfmq_dm_tpu/models/ldm_units.py``). The reconstruction unit specs and
``unit_fwd`` wait for the calibration slice."""

from __future__ import annotations

from ..quant.adapter import ModelAdapter
from ..quant.policy import QuantPolicy, build_policy
from . import ldm_unet


def build_adapter(cfg: ldm_unet.LDMUNetConfig,
                  policy: QuantPolicy = None, *, w_bits: int = 4,
                  a_bits: int = 8, softmax_a_bit: int = 8,
                  use_aq: bool = False,
                  w_sym: bool = False) -> ModelAdapter:
    if policy is None:
        policy = build_policy(ldm_unet.layer_infos(cfg, use_aq=use_aq),
                              w_bits=w_bits, a_bits=a_bits,
                              softmax_a_bit=softmax_a_bit, w_sym=w_sym)

    def forward(params, ctx, x, t, c=None, y=None, kv_cache=None):
        return ldm_unet.apply(params, cfg, x, t, context=c, y=y, qctx=ctx,
                              kv_cache=kv_cache)

    return ModelAdapter(policy=policy, forward=forward)
