"""Quantization policy: which named call sites quantize, and how (the
port's copy of ``tfmq_dm_tpu/quant/policy.py``).

The reference mutates an nn.Module tree (wrap Conv/Linear in QuantLayer,
skip shortcut/skip/downsample convs, tag emb layers, disable first/last
layers — quant_model.py:49-66,103-120). Here the model is a pure function
with *named* call sites, and the policy is an explicit, static table built
from the model's layer inventory. Everything here is plain Python data —
hashable-by-identity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .quantizer import QCfg


@dataclasses.dataclass
class LayerInfo:
    """One quantizable call site, declared by the model in *module order*
    (the order torch's named_modules() would yield, which the reference
    uses for its first/last-layer exclusions and recon traversal)."""

    name: str
    kind: str  # "conv" | "linear" | "act"
    quant_emb: bool = False  # temb_proj / emb_layers.1 — reconstructed by TIB
    softmax: bool = False    # attention-softmax output (act sites only)
    unit: Optional[str] = None  # owning reconstruction unit name


@dataclasses.dataclass
class LayerPolicy:
    wq: bool = True       # quantize this layer's weight
    aq: bool = True       # quantize this layer's input activation
    recon: bool = False   # participate in reconstruction (ignore_recon=False)
    quant_emb: bool = False
    w_cfg: Optional[QCfg] = None   # None for act-only sites
    a_cfg: Optional[QCfg] = None


class QuantPolicy:
    """Maps layer names -> LayerPolicy. Built by ``build_policy``."""

    def __init__(self, layers: Dict[str, LayerPolicy], order: List[str]):
        self.layers = layers
        self.order = order  # weight-layer names in module order

    def get(self, name: str) -> Optional[LayerPolicy]:
        return self.layers.get(name)

    def weight_layers(self) -> List[str]:
        return [n for n in self.order
                if self.layers[n].w_cfg is not None]

    def act_sites(self) -> List[str]:
        return [n for n, p in self.layers.items() if p.aq]


def build_policy(infos: List[LayerInfo],
                 w_bits: int = 4,
                 a_bits: int = 8,
                 softmax_a_bit: int = 8,
                 exclude_first_last: bool = True,
                 w_sym: bool = False) -> QuantPolicy:
    """Build the default TFMQ policy from a model's layer inventory.

    Replicates ``QuantModel.disable_out_quantization`` (quant_model.py:
    103-120) on the ordered list of weight layers:
      idx 0   : no wq, no aq, no recon      (time-emb dense0 / SD time_embed.0)
      idx 1   : no aq                        (time-emb dense1)
      idx 2   : no wq, no aq, no recon      (conv_in / input_blocks.0.0)
      idx 3   : no aq                        (first block conv)
      idx -1  : no wq, no aq, no recon      (conv_out)
    Shortcut/skip/downsample convs are simply absent from ``infos`` (the
    model does not declare them), matching quant_model.py:57-58.
    """
    layers: Dict[str, LayerPolicy] = {}
    order: List[str] = []
    for info in infos:
        if info.kind == "act":
            bits = softmax_a_bit if info.softmax else a_bits
            layers[info.name] = LayerPolicy(
                wq=False, aq=True, recon=False, quant_emb=False,
                w_cfg=None,
                a_cfg=QCfg(bits=bits, symmetric=False, channel_wise=False,
                           always_zero=info.softmax))
        else:
            layers[info.name] = LayerPolicy(
                wq=True, aq=True, recon=True, quant_emb=info.quant_emb,
                w_cfg=QCfg(bits=w_bits, symmetric=w_sym,
                           channel_wise=True),
                a_cfg=QCfg(bits=a_bits, symmetric=False, channel_wise=False))
            order.append(info.name)

    if exclude_first_last and len(order) >= 5:
        for idx in (0, 2, -1):
            p = layers[order[idx]]
            p.wq = False
            p.aq = False
            p.recon = False
        for idx in (1, 3):
            layers[order[idx]].aq = False

    return QuantPolicy(layers, order)
