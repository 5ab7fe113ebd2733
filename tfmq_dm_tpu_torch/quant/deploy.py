"""Deployment: calibrated state -> integer weights and a model function
that executes them (port of ``tfmq_dm_tpu/quant/deploy.py``).

Every wq-enabled layer's weights are quantized with the calibrated (delta,
zp[, alpha]) to centered int8 codes (``ops/int_ops.IntWeight``), which the
exact int8 conv and linear execute. 4-bit linear weights of weight-only
sites are nibble-packed (``ops/int4_kernels.pack_int4``), and
``int4_serving`` packs every 4-bit conv and linear: the deployed model then
reads half the bytes of int8 codes. The port packs to its own layout and
needs none of the TPU's 256-channel padding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..ops import int_ops
from ..ops.int4_kernels import pack_int4, unpack_int4
from ..ops.nn import exact_f32
from .adapter import ModelAdapter
from .adaround import adaround_fq
from .context import QuantCtx
from .fsc import pack_fsc, slice_fsc, unpack_fsc
from .policy import QuantPolicy
from .quantizer import broadcast_channel


@dataclasses.dataclass
class Int4Weight:
    """Packed 4-bit linear weight (runs ``int4_linear``)."""

    w_packed: torch.Tensor  # (K, ceil(N/2)) uint8 nibble pairs
    delta: torch.Tensor     # (N,) per-channel scale
    zp_c: torch.Tensor      # (N,) centered zero point (zp - 8)
    k: int
    n: int


@dataclasses.dataclass
class Int4ConvWeight:
    """Packed 4-bit conv weight (runs ``int4_conv2d``), one (Cin, N) code
    matrix per kernel tap."""

    w_packed: torch.Tensor  # (kh*kw, cin, ceil(N/2)) uint8 nibble pairs
    delta: torch.Tensor     # (N,) per-channel scale
    zp_c: torch.Tensor      # (N,) centered zero point
    kh: int
    kw: int
    cin: int
    n: int


def _pack_conv_int4(iw: int_ops.IntWeight) -> Int4ConvWeight:
    kh, kw, cin, n = iw.w_q.shape
    return Int4ConvWeight(
        w_packed=pack_int4(iw.w_q.reshape(kh * kw, cin, n)),
        delta=iw.delta.contiguous(), zp_c=iw.zp_c.contiguous(),
        kh=kh, kw=kw, cin=cin, n=n)


def _pack_linear_int4(iw: int_ops.IntWeight) -> Int4Weight:
    k, n = iw.w_q.shape
    return Int4Weight(w_packed=pack_int4(iw.w_q),
                      delta=iw.delta.contiguous(),
                      zp_c=iw.zp_c.contiguous(), k=k, n=n)


def dequant_int4(iw: Int4Weight, dtype=torch.float32) -> torch.Tensor:
    """Unpack + dequant to the full (K, N) weight."""
    w_q = unpack_int4(iw.w_packed, iw.n).float()
    return (iw.delta[None, :] * (w_q - iw.zp_c[None, :])).to(dtype)


def dequant_int4_conv(iw: Int4ConvWeight,
                      dtype=torch.float32) -> torch.Tensor:
    """Unpack + dequant to the full HWIO weight."""
    w_q = unpack_int4(iw.w_packed, iw.n).float()
    w = iw.delta[None, None, :] * (w_q - iw.zp_c[None, None, :])
    return w.reshape(iw.kh, iw.kw, iw.cin, iw.n).to(dtype)


def cast_fp_params(params, dtype=torch.bfloat16):
    """Fast-deploy carrier cast (deploy.py:139-146): every float32 tensor
    of the parameter tree (FP layers, biases, norm parameters) moves to
    ``dtype``; integer and quantized state is untouched."""
    if isinstance(params, dict):
        return {k: cast_fp_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(dtype)
    return params


def deploy_weights(policy: QuantPolicy, params, wstate: Dict, *,
                   int4_serving: bool = False) -> Dict[str, object]:
    """Quantize every wq-enabled layer's weights to centered integers with
    the calibrated (delta, zp[, alpha]). 4-bit linear weights of
    weight-only sites are nibble-packed; ``int4_serving`` also packs
    4-bit conv weights and act-quantized linears (deploy.py:184-233).
    Everything else keeps int8 codes (``int_ops.IntWeight``); grids wider
    than 8 bits keep their fake-quantized weights (``FPWeight``)."""
    deployed = {}
    for name in policy.weight_layers():
        pol = policy.get(name)
        st = wstate.get(name)
        if not pol.wq or st is None:
            continue
        w = params[name]["w"]
        if not int_ops.fits_int8(pol.w_cfg):
            # >8-bit grid: materialize the fake-quantized weights offline
            if "alpha" in st:
                w_fq = adaround_fq(w, st["delta"], st["zp"], st["alpha"],
                                   pol.w_cfg, soft=False)
            else:
                d = broadcast_channel(st["delta"], w.shape)
                zp = broadcast_channel(st["zp"], w.shape)
                nb, pb = pol.w_cfg.qrange
                w_q = torch.clamp(torch.round(w * (1.0 / d)) + zp, nb, pb)
                w_fq = d * (w_q - zp)
            deployed[name] = int_ops.FPWeight(w=w_fq)
            continue
        iw = int_ops.quantize_weight_int(w, st["delta"], st["zp"],
                                         pol.w_cfg, alpha=st.get("alpha"))
        if (pol.w_cfg.bits == 4 and iw.w_q.ndim == 2
                and (int4_serving or not pol.aq)):
            deployed[name] = _pack_linear_int4(iw)
        elif int4_serving and pol.w_cfg.bits == 4 and iw.w_q.ndim == 4:
            deployed[name] = _pack_conv_int4(iw)
        else:
            deployed[name] = iw
    return deployed


@torch.no_grad()
def specialize_maps(adapter: ModelAdapter, params, deployed: Dict, *,
                    example_args: tuple, use_aq: bool = True) -> Dict:
    """Precompute every act-quantized int8 conv's border maps for the
    geometry the model runs (deploy.py:202-249), so that the deployed
    forward computes none per call. JAX finds the geometry with
    ``jax.eval_shape``; the port runs one forward on ``example_args``
    ((x, t[, cond...]) at the deployment's resolution; batch 1 is enough)
    with the context's ``shape_tape`` set and no activation state, which
    takes the weight-only branches. A deployment without act-quantized
    int8 convs (``int4_serving``, weight-only) needs no maps and no
    forward."""
    if not use_aq or not any(
            isinstance(iw, int_ops.IntWeight) and iw.w_q.ndim == 4
            and adapter.policy.get(name).aq
            for name, iw in deployed.items()):
        return dict(deployed)
    ctx = QuantCtx(adapter.policy, wstate={}, astate={}, use_wq=True,
                   use_aq=use_aq, deploy=deployed)
    ctx.shape_tape = {}
    adapter.forward(params, ctx, *example_args)
    out = dict(deployed)
    for name, (hw, stride, pads) in ctx.shape_tape.items():
        iw = deployed.get(name)
        if not isinstance(iw, int_ops.IntWeight) or iw.w_q.ndim != 4:
            continue
        pol = adapter.policy.get(name)
        if not (use_aq and pol is not None and pol.aq):
            continue    # weight-only convs don't use border maps
        w_map, v_map = int_ops.border_maps(iw.w_q, hw, stride, pads)
        out[name] = dataclasses.replace(
            iw, w_map=w_map, v_map=None if iw.sym else v_map)
    return out


def make_deployed_model_fn(adapter: ModelAdapter, params,
                           deployed: Dict[str, object],
                           astate_batched: Optional[Dict] = None, *,
                           use_aq: bool = False, group_of_step=None,
                           act_dtype=torch.float32,
                           kv_cache_fn=None) -> Callable:
    """model_fn(x, t, step, *cond) that executes the deployed weights
    (deploy.py:252-296); the FSC activation state is selected per sampler
    step (group = step, or ``group_of_step[step]``), the contexts take the
    flash kernels and carry ``act_dtype`` between deployed layers.
    ``kv_cache_fn``: optional ``(qctx) -> cache``, called once with a
    group-0 context, so that the cross-attention K/V of a constant context
    run once per prompt. Turns TF32 off (``ops.nn.exact_f32``)."""
    exact_f32()

    def make_ctx(astate):
        return QuantCtx(adapter.policy, wstate={}, astate=astate,
                        use_wq=True, use_aq=use_aq, deploy=deployed,
                        act_out_dtype=act_dtype, flash=True)

    kv_cache = None
    if kv_cache_fn is not None:
        astate0 = slice_fsc(astate_batched, 0) \
            if (use_aq and astate_batched) else {}
        kv_cache = kv_cache_fn(make_ctx(astate0))
    packed = pack_fsc(astate_batched) \
        if (use_aq and astate_batched) else None

    def model_fn(x, t, step: int, *cond):
        astate = {}
        if packed is not None:
            g = step if group_of_step is None else int(group_of_step[step])
            flat, spec = packed
            astate = unpack_fsc(flat[g], spec)
        ctx = make_ctx(astate)
        if kv_cache is not None:
            return adapter.forward(params, ctx, x, t, *cond,
                                   kv_cache=kv_cache)
        return adapter.forward(params, ctx, x, t, *cond)

    return model_fn
