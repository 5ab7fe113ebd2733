"""LDM / SD UNet adapter for the reconstruction engine (port of
``tfmq_dm_tpu/models/ldm_units.py``).

Unit kinds mirror the reference's wrapper classes (quant_block.py):

- "res_ldm"  <- QuantResBlock            (:131-210)
- "attn_ldm" <- QuantAttentionBlock + QuantQKMatMul/QuantSMVMatMul
                (:357-387, 303-354; the matmul sites exist with use_aq)
- "btb"      <- QuantBasicTransformerBlock (:252-299)
- "layer"    <- a standalone QuantLayer (SpatialTransformer proj_in/out,
                the Upsample convs; conv_in/out are kept out of recon by
                the policy)
- "tib_ldm"  <- QuantTemporalInformationBlock (:78-127)

Units come in module (forward) order, the recon_model DFS
(calibration.py:56-84). A ResBlock's captured input is (x, emb_out),
emb_out the projected time embedding: ``emb_layers.1`` is quant_emb (its
alphas are fixed, hard-rounded, after the TIB), so projecting once at
capture equals the reference's projection at every iteration. The TIB's
input is the timestep alone, as in the JAX package (recon.py:197-207).

Unit forwards are plain PyTorch, attention as materialized matrix
products, as the JAX package's are plain XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..ops import nn as fnn
from ..quant.adapter import ModelAdapter, UnitSpec
from ..quant.policy import QuantPolicy, build_policy
from . import ldm_unet
from .ddim_units import _qa, _qw, _rc, _softmax


def _qconv(x, uparams, wstate, astate, rc, soft_on, use_aq,
           padding="SAME"):
    x = _qa(x, astate.get(rc.role), rc, use_aq)
    w = _qw(uparams[rc.role]["w"], wstate.get(rc.role), rc, soft_on)
    return fnn.conv2d(x, w, uparams[rc.role].get("b"), padding=padding)


def _qlin(x, uparams, wstate, astate, rc, soft_on, use_aq):
    x = _qa(x, astate.get(rc.role), rc, use_aq)
    w = _qw(uparams[rc.role]["w"], wstate.get(rc.role), rc, soft_on)
    return fnn.linear(x, w, uparams[rc.role].get("b"))


def _norm(p, x):
    return fnn.group_norm(x, p["scale"], p["bias"], groups=32, eps=1e-5)


def _lnorm(p, x):
    return fnn.layer_norm(x, p["scale"], p["bias"], eps=1e-5)


# ---------------------------------------------------------------------------
# unit forwards (role-keyed)
# ---------------------------------------------------------------------------

def unit_fwd(kind: str, role_cfgs: tuple, extra: tuple, uparams: Dict,
             wstate: Dict, astate: Dict, inputs: tuple, soft_on: bool,
             use_aq: bool):
    fwd = {"res_ldm": _res_fwd, "attn_ldm": _attn_fwd, "btb": _btb_fwd,
           "layer": _layer_fwd, "tib_ldm": _tib_fwd}.get(kind)
    if fwd is None:
        raise ValueError(kind)
    return fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
               use_aq)


def _res_fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
             use_aq):
    """QuantResBlock.forward: input (x, emb_out)."""
    use_scale_shift, updown = extra
    x, emb_out = inputs
    h = fnn.swish(_norm(uparams["in0"], x))
    if updown == 1:
        h = fnn.nearest_upsample_2x(h)
        x = fnn.nearest_upsample_2x(x)
    elif updown == 2:
        h = fnn.avg_pool_2x(h)
        x = fnn.avg_pool_2x(x)
    h = _qconv(h, uparams, wstate, astate, _rc(role_cfgs, "in2"), soft_on,
               use_aq)
    if use_scale_shift:
        scale, shift = emb_out.chunk(2, dim=-1)
        h = _norm(uparams["out0"], h) * (1.0 + scale[:, None, None, :]) \
            + shift[:, None, None, :]
    else:
        h = _norm(uparams["out0"], h + emb_out[:, None, None, :])
    h = fnn.swish(h)
    h = _qconv(h, uparams, wstate, astate, _rc(role_cfgs, "out3"), soft_on,
               use_aq)
    sc = uparams.get("skip")
    if sc is not None:
        x = fnn.conv2d(x, sc["w"], sc.get("b"), padding="VALID")
    return x + h


def _attn_fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
              use_aq):
    """QuantAttentionBlock.forward (QKVAttentionLegacy): input (x,)."""
    (heads,) = extra
    (x,) = inputs
    b, hh, ww, c = x.shape
    t = hh * ww
    xs = x.reshape(b, t, c)
    qkv = _qlin(_norm(uparams["norm"], xs), uparams, wstate, astate,
                _rc(role_cfgs, "qkv"), soft_on, use_aq)
    ch = c // heads
    q, k, v = qkv.reshape(b, t, heads, 3 * ch).chunk(3, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    q = _qa(q * scale, astate.get("aq_q"), _rc(role_cfgs, "aq_q"), use_aq)
    k = _qa(k * scale, astate.get("aq_k"), _rc(role_cfgs, "aq_k"), use_aq)
    w_ = _softmax(torch.einsum("bthc,bshc->bhts", q, k), -1).to(x.dtype)
    w_ = _qa(w_, astate.get("aq_w"), _rc(role_cfgs, "aq_w"), use_aq)
    v = _qa(v, astate.get("aq_v"), _rc(role_cfgs, "aq_v"), use_aq)
    a = torch.einsum("bhts,bshc->bthc", w_, v).to(x.dtype).reshape(b, t, c)
    h_ = _qlin(a, uparams, wstate, astate, _rc(role_cfgs, "proj_out"),
               soft_on, use_aq)
    return (xs + h_).reshape(b, hh, ww, c)


def _one_cross_attn(tag, role_cfgs, uparams, wstate, astate, x, context,
                    heads, d_head, soft_on, use_aq):
    q = _qlin(x, uparams, wstate, astate, _rc(role_cfgs, f"{tag}.to_q"),
              soft_on, use_aq)
    ctx = x if context is None else context
    k = _qlin(ctx, uparams, wstate, astate, _rc(role_cfgs, f"{tag}.to_k"),
              soft_on, use_aq)
    v = _qlin(ctx, uparams, wstate, astate, _rc(role_cfgs, f"{tag}.to_v"),
              soft_on, use_aq)
    b, tq, _ = q.shape
    tk = k.shape[1]
    q = _qa(q.reshape(b, tq, heads, d_head), astate.get(f"{tag}.aq_q"),
            _rc(role_cfgs, f"{tag}.aq_q"), use_aq)
    k = _qa(k.reshape(b, tk, heads, d_head), astate.get(f"{tag}.aq_k"),
            _rc(role_cfgs, f"{tag}.aq_k"), use_aq)
    sim = torch.einsum("bihd,bjhd->bhij", q, k) * (d_head ** -0.5)
    attn = _softmax(sim, -1).to(x.dtype)
    attn = _qa(attn, astate.get(f"{tag}.aq_w"),
               _rc(role_cfgs, f"{tag}.aq_w"), use_aq)
    v = _qa(v.reshape(b, tk, heads, d_head), astate.get(f"{tag}.aq_v"),
            _rc(role_cfgs, f"{tag}.aq_v"), use_aq)
    out = torch.einsum("bhij,bjhd->bihd", attn, v).to(x.dtype)
    return _qlin(out.reshape(b, tq, heads * d_head), uparams, wstate,
                 astate, _rc(role_cfgs, f"{tag}.to_out"), soft_on, use_aq)


def _btb_fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
             use_aq):
    """QuantBasicTransformerBlock.forward: input (x, context); GEGLU with
    the exact (erf) GELU."""
    heads, d_head = extra
    x, context = inputs
    x = _one_cross_attn("attn1", role_cfgs, uparams, wstate, astate,
                        _lnorm(uparams["norm1"], x), None, heads, d_head,
                        soft_on, use_aq) + x
    x = _one_cross_attn("attn2", role_cfgs, uparams, wstate, astate,
                        _lnorm(uparams["norm2"], x), context, heads,
                        d_head, soft_on, use_aq) + x
    h = _qlin(_lnorm(uparams["norm3"], x), uparams, wstate, astate,
              _rc(role_cfgs, "ff0"), soft_on, use_aq)
    h = _qlin(fnn.geglu(h), uparams, wstate, astate, _rc(role_cfgs, "ff2"),
              soft_on, use_aq)
    return h + x


def _layer_fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
               use_aq):
    """A standalone QuantLayer on its direct input: 1x1 convs VALID, 3x3
    SAME (from the weight's shape)."""
    (x,) = inputs
    rc = _rc(role_cfgs, "layer")
    p = uparams["layer"]
    if p["w"].ndim == 4:
        padding = "VALID" if p["w"].shape[0] == 1 else "SAME"
        return _qconv(x, {"layer": p}, wstate, astate, rc, soft_on,
                      use_aq, padding=padding)
    return _qlin(x, {"layer": p}, wstate, astate, rc, soft_on, use_aq)


def _tib_fwd(role_cfgs, extra, uparams, wstate, astate, inputs, soft_on,
             use_aq):
    """QuantTemporalInformationBlock.forward: input (t,), output the
    tuple of every emb_layers projection."""
    model_channels, n_proj = extra
    emb = fnn.timestep_embedding_ldm(inputs[0], model_channels)
    emb = _qlin(emb, uparams, wstate, astate, _rc(role_cfgs, "te0"),
                soft_on, use_aq)
    emb = _qlin(fnn.swish(emb), uparams, wstate, astate,
                _rc(role_cfgs, "te2"), soft_on, use_aq)
    silu = fnn.swish(emb)
    return tuple(
        _qlin(silu, uparams, wstate, astate, _rc(role_cfgs, f"proj_{i}"),
              soft_on, use_aq)
        for i in range(n_proj))


# ---------------------------------------------------------------------------
# unit construction
# ---------------------------------------------------------------------------

_RES_PARAM_ROLES = {"in0": "in_layers.0", "in2": "in_layers.2",
                    "out0": "out_layers.0", "out3": "out_layers.3"}
_BTB_W_ROLES = {
    "attn1.to_q": "attn1.to_q", "attn1.to_k": "attn1.to_k",
    "attn1.to_v": "attn1.to_v", "attn1.to_out": "attn1.to_out.0",
    "attn2.to_q": "attn2.to_q", "attn2.to_k": "attn2.to_k",
    "attn2.to_v": "attn2.to_v", "attn2.to_out": "attn2.to_out.0",
    "ff0": "ff.net.0.proj", "ff2": "ff.net.2"}
_BTB_A_ROLES = {
    "attn1.aq_q": "attn1.aqtizer_q", "attn1.aq_k": "attn1.aqtizer_k",
    "attn1.aq_v": "attn1.aqtizer_v", "attn1.aq_w": "attn1.aqtizer_w",
    "attn2.aq_q": "attn2.aqtizer_q", "attn2.aq_k": "attn2.aqtizer_k",
    "attn2.aq_v": "attn2.aqtizer_v", "attn2.aq_w": "attn2.aqtizer_w"}


def build_units(cfg: ldm_unet.LDMUNetConfig,
                use_aq: bool = False) -> Tuple[UnitSpec, ...]:
    projs = [n for _, n, _ in ldm_unet.iter_layers(cfg)
             if n.endswith("emb_layers.1")]
    units = [UnitSpec(
        name="tib", kind="tib_ldm",
        layers=(("te0", "time_embed.0"), ("te2", "time_embed.2"))
        + tuple((f"proj_{i}", n) for i, n in enumerate(projs)),
        extra=(cfg.model_channels, len(projs)))]
    inputs, middle, outputs = build_structure_units(cfg)
    for s in inputs + list(middle) + outputs:
        units.extend(_subs_to_units(cfg, s, use_aq))
    return tuple(units)


def build_structure_units(cfg: ldm_unet.LDMUNetConfig):
    """The structure's subs flattened: (input subs, middle, output
    subs)."""
    inputs, middle, outputs = ldm_unet.build_structure(cfg)
    return ([s for g in inputs for s in g], middle,
            [s for g in outputs for s in g])


def _subs_to_units(cfg, s: ldm_unet.Sub, use_aq: bool):
    if s.kind == "conv":
        return [UnitSpec(name=s.prefix, kind="layer",
                         layers=(("layer", s.prefix),))]
    if s.kind == "res":
        layers = tuple((r, f"{s.prefix}.{p}") for r, p in
                       (("in2", "in_layers.2"), ("emb", "emb_layers.1"),
                        ("out3", "out_layers.3")))
        return [UnitSpec(name=s.prefix, kind="res_ldm", layers=layers,
                         extra=(cfg.use_scale_shift_norm, s.updown))]
    if s.kind == "attn":
        layers = (("qkv", f"{s.prefix}.qkv"),
                  ("proj_out", f"{s.prefix}.proj_out"))
        acts = ()
        if use_aq:
            acts = (
                ("aq_q", f"{s.prefix}.attention.qkv_matmul.aqtizer_q"),
                ("aq_k", f"{s.prefix}.attention.qkv_matmul.aqtizer_k"),
                ("aq_w", f"{s.prefix}.attention.smv_matmul.aqtizer_w"),
                ("aq_v", f"{s.prefix}.attention.smv_matmul.aqtizer_v"))
        return [UnitSpec(name=s.prefix, kind="attn_ldm", layers=layers,
                         act_sites=acts, extra=(s.heads,))]
    if s.kind == "strans":
        units = [UnitSpec(name=f"{s.prefix}.proj_in", kind="layer",
                          layers=(("layer", f"{s.prefix}.proj_in"),))]
        for d in range(s.depth):
            p = f"{s.prefix}.transformer_blocks.{d}"
            units.append(UnitSpec(
                name=p, kind="btb",
                layers=tuple((r, f"{p}.{sub}")
                             for r, sub in _BTB_W_ROLES.items()),
                act_sites=tuple((r, f"{p}.{sub}")
                                for r, sub in _BTB_A_ROLES.items()),
                extra=(s.heads, s.d_head)))
        units.append(UnitSpec(name=f"{s.prefix}.proj_out", kind="layer",
                              layers=(("layer", f"{s.prefix}.proj_out"),)))
        return units
    if s.kind == "up":
        name = f"{s.prefix}.conv"
        return [UnitSpec(name=name, kind="layer", layers=(("layer", name),))]
    return []  # down: not quantized


def extract_uparams(params, unit: UnitSpec) -> Dict:
    """The role-keyed parameters of one unit."""
    if unit.kind == "res_ldm":
        up = {r: params[f"{unit.name}.{p}"]
              for r, p in _RES_PARAM_ROLES.items()}
        sc = params.get(f"{unit.name}.skip_connection")
        if sc is not None:
            up["skip"] = sc
        return up
    if unit.kind == "attn_ldm":
        return {r: params[f"{unit.name}.{r}"]
                for r in ("norm", "qkv", "proj_out")}
    if unit.kind == "btb":
        up = {r: params[f"{unit.name}.{p}"] for r, p in _BTB_W_ROLES.items()}
        for n in ("norm1", "norm2", "norm3"):
            up[n] = params[f"{unit.name}.{n}"]
        return up
    if unit.kind == "layer":
        return {"layer": params[unit.name]}
    if unit.kind == "tib_ldm":
        return {r: params[f] for r, f in unit.layers}
    raise ValueError(unit.kind)


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

    return ModelAdapter(policy=policy, forward=forward,
                        units=build_units(cfg, use_aq), unit_fwd=unit_fwd,
                        extract_uparams=extract_uparams)
