"""DDIM UNet adapter for the reconstruction and calibration engine (port of
``tfmq_dm_tpu/models/ddim_units.py``).

Maps the UNet (ddim_unet.py) onto the unit protocol (quant/adapter.py).
Unit kinds mirror the reference's wrapper classes:

- "res"   <- QuantResnetBlock   (quant_block.py:391-444)
- "attn"  <- QuantAttnBlock     (quant_block.py:446-505)
- "layer" <- a standalone QuantLayer (the upsample convs; conv_in and
             conv_out are kept out of recon by the policy,
             quant_model.py:103-120)
- "tib"   <- QuantTemporalInformationBlockDDIM (quant_block.py:36-75)

Unit forwards are role-keyed: one function per kind serves every block of
that kind. They are plain PyTorch: convs, GroupNorm and attention as
matrix products (CIFAR-10's T = 256 is below the flash gate).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops import nn as fnn
from ..quant.adapter import ModelAdapter, RoleCfg, UnitSpec
from ..quant.adaround import adaround_fq
from ..quant.policy import QuantPolicy, build_policy
from ..quant.quantizer import broadcast_channel, fake_quant
from . import ddim_unet


# ---------------------------------------------------------------------------
# role-level quant helpers
# ---------------------------------------------------------------------------

def _qw(w, st, rc: RoleCfg, soft_on: bool):
    """Weight fake-quant of a role: AdaRound when an alpha is present
    (soft iff this role trains in the running unit), else nearest."""
    if rc.w_cfg is None or st is None:
        return w
    if st.get("alpha") is not None:
        return adaround_fq(w, st["delta"], st["zp"], st["alpha"], rc.w_cfg,
                           soft=rc.train and soft_on)
    d = broadcast_channel(st["delta"], w.shape)
    z = broadcast_channel(st["zp"], w.shape)
    return fake_quant(w, d, z, rc.w_cfg)


def _qa(x, st, rc: RoleCfg, use_aq: bool):
    if not use_aq or not rc.aq or rc.a_cfg is None or st is None:
        return x
    return fake_quant(x, st["delta"], st["zp"], rc.a_cfg)


def _rc(role_cfgs: tuple, role: str) -> RoleCfg:
    for r in role_cfgs:
        if r.role == role:
            return r
    return RoleCfg(role=role)


# ---------------------------------------------------------------------------
# unit forwards (role-keyed)
# ---------------------------------------------------------------------------

def unit_fwd(kind: str, role_cfgs: tuple, extra: tuple, uparams: Dict,
             wstate: Dict, astate: Dict, inputs: tuple, soft_on: bool,
             use_aq: bool):
    if kind == "res":
        return _res_fwd(role_cfgs, uparams, wstate, astate, inputs,
                        soft_on, use_aq)
    if kind == "attn":
        return _attn_fwd(role_cfgs, uparams, wstate, astate, inputs,
                         soft_on, use_aq)
    if kind == "layer":
        return _layer_fwd(role_cfgs, uparams, wstate, astate, inputs,
                          soft_on, use_aq)
    if kind == "tib":
        return _tib_fwd(role_cfgs, extra, uparams, wstate, astate, inputs,
                        soft_on, use_aq)
    raise ValueError(kind)


def _qconv(x, uparams, wstate, astate, rc, soft_on, use_aq,
           padding="SAME"):
    x = _qa(x, astate.get(rc.role), rc, use_aq)
    w = _qw(uparams[rc.role]["w"], wstate.get(rc.role), rc, soft_on)
    return fnn.conv2d(x, w, uparams[rc.role].get("b"), padding=padding)


def _qlinear(x, uparams, wstate, astate, rc, soft_on, use_aq):
    x = _qa(x, astate.get(rc.role), rc, use_aq)
    w = _qw(uparams[rc.role]["w"], wstate.get(rc.role), rc, soft_on)
    return fnn.linear(x, w, uparams[rc.role].get("b"))


def _norm(p, x):
    return fnn.group_norm(x, p["scale"], p["bias"], groups=32, eps=1e-6)


def _res_fwd(role_cfgs, uparams, wstate, astate, inputs, soft_on, use_aq):
    """QuantResnetBlock.forward (quant_block.py:415-444): input (x, temb)."""
    x, temb = inputs
    h = fnn.swish(_norm(uparams["norm1"], x))
    h = _qconv(h, uparams, wstate, astate, _rc(role_cfgs, "conv1"),
               soft_on, use_aq)
    proj = _qlinear(fnn.swish(temb), uparams, wstate, astate,
                    _rc(role_cfgs, "temb_proj"), soft_on, use_aq)
    h = h + proj[:, None, None, :]
    h = fnn.swish(_norm(uparams["norm2"], h))
    h = _qconv(h, uparams, wstate, astate, _rc(role_cfgs, "conv2"),
               soft_on, use_aq)
    sc = uparams.get("nin_shortcut")
    if sc is not None:
        x = fnn.conv2d(x, sc["w"], sc.get("b"), padding="VALID")
    return x + h


def _softmax(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: exp(a - max) / sum, no gradient through max."""
    e = torch.exp(a - a.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


def _attn_fwd(role_cfgs, uparams, wstate, astate, inputs, soft_on, use_aq):
    """QuantAttnBlock.forward (quant_block.py:475-503): input (x,)."""
    (x,) = inputs
    b, h, w, c = x.shape
    h_ = _norm(uparams["norm"], x)
    q, k, v = (_qconv(h_, uparams, wstate, astate, _rc(role_cfgs, r),
                      soft_on, use_aq, padding="VALID")
               .reshape(b, h * w, c) for r in ("q", "k", "v"))
    q = _qa(q, astate.get("aqtizer_q"), _rc(role_cfgs, "aqtizer_q"), use_aq)
    k = _qa(k, astate.get("aqtizer_k"), _rc(role_cfgs, "aqtizer_k"), use_aq)
    attn = _softmax(torch.bmm(q, k.transpose(1, 2)) * (c ** -0.5), 2)
    v = _qa(v, astate.get("aqtizer_v"), _rc(role_cfgs, "aqtizer_v"), use_aq)
    attn = _qa(attn, astate.get("aqtizer_w"), _rc(role_cfgs, "aqtizer_w"),
               use_aq)
    h_ = torch.bmm(attn, v).to(x.dtype).reshape(b, h, w, c)
    h_ = _qconv(h_, uparams, wstate, astate, _rc(role_cfgs, "proj_out"),
                soft_on, use_aq, padding="VALID")
    return x + h_


def _layer_fwd(role_cfgs, uparams, wstate, astate, inputs, soft_on,
               use_aq):
    """A standalone QuantLayer: its input is the layer's direct input
    (after the resize for the upsample convs, where the tap sits)."""
    (x,) = inputs
    rc = _rc(role_cfgs, "layer")
    p = uparams["layer"]
    if p["w"].ndim == 4:
        return _qconv(x, {"layer": p}, wstate, astate, rc, soft_on, use_aq)
    return _qlinear(x, {"layer": p}, wstate, astate, rc, soft_on, use_aq)


def _tib_fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
             use_aq):
    """QuantTemporalInformationBlockDDIM.forward (quant_block.py:52-64):
    input (t,), output the tuple of every temb_proj(swish(temb))."""
    t = inputs[0]
    ch, n_proj = extra
    temb = fnn.timestep_embedding(t, ch)
    temb = _qlinear(temb, uparams, wstate, astate, _rc(role_cfgs, "dense0"),
                    soft_on, use_aq)
    temb = _qlinear(fnn.swish(temb), uparams, wstate, astate,
                    _rc(role_cfgs, "dense1"), soft_on, use_aq)
    silu = fnn.swish(temb)
    return tuple(_qlinear(silu, uparams, wstate, astate,
                          _rc(role_cfgs, f"proj_{i}"), soft_on, use_aq)
                 for i in range(n_proj))


# ---------------------------------------------------------------------------
# adapter construction
# ---------------------------------------------------------------------------

_RES_ROLES = ("norm1", "conv1", "temb_proj", "norm2", "conv2")
_ATTN_ROLES = ("norm", "q", "k", "v", "proj_out")


def build_units(cfg: ddim_unet.DDIMUNetConfig) -> Tuple[UnitSpec, ...]:
    projs = [name for _, name, _ in ddim_unet.iter_layers(cfg)
             if name.endswith("temb_proj")]
    units = [UnitSpec(
        name="tib", kind="tib",
        layers=(("dense0", "temb.dense.0"), ("dense1", "temb.dense.1"))
        + tuple((f"proj_{i}", n) for i, n in enumerate(projs)),
        extra=(cfg.ch, len(projs)))]
    for uname, ukind in ddim_unet.recon_units(cfg):
        if ukind == "tib":
            continue
        if ukind == "res":
            units.append(UnitSpec(
                name=uname, kind="res",
                layers=tuple((r, f"{uname}.{r}") for r in
                             ("conv1", "temb_proj", "conv2"))))
        elif ukind == "attn":
            units.append(UnitSpec(
                name=uname, kind="attn",
                layers=tuple((r, f"{uname}.{r}") for r in
                             ("q", "k", "v", "proj_out")),
                act_sites=tuple((r, f"{uname}.{r}") for r in
                                ("aqtizer_q", "aqtizer_k", "aqtizer_v",
                                 "aqtizer_w"))))
        else:
            units.append(UnitSpec(name=uname, kind="layer",
                                  layers=(("layer", uname),)))
    return tuple(units)


def extract_uparams(params, unit: UnitSpec) -> Dict:
    """The role-keyed parameters of one unit."""
    if unit.kind == "res":
        up = {role: params[f"{unit.name}.{role}"] for role in _RES_ROLES}
        sc = params.get(f"{unit.name}.nin_shortcut")
        if sc is not None:
            up["nin_shortcut"] = sc
        return up
    if unit.kind == "attn":
        return {role: params[f"{unit.name}.{role}"] for role in _ATTN_ROLES}
    if unit.kind == "layer":
        return {"layer": params[unit.name]}
    if unit.kind == "tib":
        return {role: params[full] for role, full in unit.layers}
    raise ValueError(unit.kind)


def build_adapter(cfg: ddim_unet.DDIMUNetConfig,
                  policy: QuantPolicy = None,
                  w_bits: int = 4, a_bits: int = 8,
                  softmax_a_bit: int = 8,
                  w_sym: bool = False) -> ModelAdapter:
    if policy is None:
        policy = build_policy(ddim_unet.layer_infos(cfg), w_bits=w_bits,
                              a_bits=a_bits, softmax_a_bit=softmax_a_bit,
                              w_sym=w_sym)

    def forward(params, ctx, x, t, *rest):
        return ddim_unet.apply(params, cfg, x, t, ctx)

    return ModelAdapter(policy=policy, forward=forward,
                        units=build_units(cfg), unit_fwd=unit_fwd,
                        extract_uparams=extract_uparams)
