"""DDIM UNet adapter (port of ``build_adapter`` in
``tfmq_dm_tpu/models/ddim_units.py``)."""

from __future__ import annotations

from ..quant.adapter import ModelAdapter
from ..quant.policy import QuantPolicy, build_policy
from . import ddim_unet


def build_adapter(cfg: ddim_unet.DDIMUNetConfig,
                  policy: QuantPolicy = None,
                  w_bits: int = 4, a_bits: int = 8,
                  softmax_a_bit: int = 8,
                  w_sym: bool = False) -> ModelAdapter:
    if policy is None:
        policy = build_policy(ddim_unet.layer_infos(cfg), w_bits=w_bits,
                              a_bits=a_bits, softmax_a_bit=softmax_a_bit,
                              w_sym=w_sym)

    def forward(params, ctx, x, t):
        return ddim_unet.apply(params, cfg, x, t, ctx)

    return ModelAdapter(policy=policy, forward=forward)
