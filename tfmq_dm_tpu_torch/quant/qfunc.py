"""Quantized call-site wrappers (port of ``tfmq_dm_tpu/quant/qfunc.py``).

Each quantizable op goes through one of these with its unique layer name:
optional input fake-quant -> (quantized or FP) weight -> conv/linear. In
deploy mode (``qctx.deploy``) a layer with packed 4-bit weights runs the
packed-int4 kernels of ``ops/int4_kernels.py``: every stride-1 SAME/VALID
conv runs ``int4_conv2d`` and every linear runs ``int4_linear``. The
kernels dispatch on the tensor's device (CUDA: the hand-written kernel;
CPU: its plain version).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import int4_kernels, int_ops
from ..ops import nn as fnn
from .context import QuantCtx
from .deploy import Int4ConvWeight, Int4Weight, dequant_int4_conv
from .quantizer import fake_quant


def _deployed_act(qctx: QuantCtx, name: str, x: torch.Tensor):
    """Fake-quantize a deployed layer's input when its act site is live."""
    pol = qctx.policy.get(name)
    ast = qctx.astate.get(name) if qctx.use_aq and pol.aq else None
    if ast is not None:
        x = fake_quant(x, ast["delta"], ast["zp"], pol.a_cfg)
    return x


def qconv2d(qctx: Optional[QuantCtx], name: str, x: torch.Tensor,
            params: dict, stride: int = 1,
            padding: str = "SAME") -> torch.Tensor:
    w, b = params["w"], params.get("b")
    if qctx is not None and qctx.deploy is not None and \
            name in qctx.deploy:
        iw = qctx.deploy[name]
        out_dtype = x.dtype
        x = _deployed_act(qctx, name, x)
        if isinstance(iw, int_ops.FPWeight):
            return fnn.conv2d(x, iw.w.to(out_dtype), b, stride=stride,
                              padding=padding)
        if isinstance(iw, Int4ConvWeight):
            if stride == 1:
                out = int4_kernels.int4_conv2d(
                    x.to(torch.bfloat16).contiguous(), iw.w_packed,
                    iw.delta, iw.zp_c, iw.kh, iw.kw, bias=b,
                    padding=padding)
                return out.to(out_dtype)
            return fnn.conv2d(x, dequant_int4_conv(iw, out_dtype), b,
                              stride=stride, padding=padding)
        raise NotImplementedError(
            f"{name}: deployed {type(iw).__name__} conv needs the int8 "
            "deployment (without --int4-serving), not ported yet")
    if qctx is not None:
        x = qctx.qact(name, x)
        w = qctx.qweight(name, w)
    return fnn.conv2d(x, w, b, stride=stride, padding=padding)


def qlinear(qctx: Optional[QuantCtx], name: str, x: torch.Tensor,
            params: dict) -> torch.Tensor:
    w, b = params["w"], params.get("b")
    if qctx is not None and qctx.deploy is not None and \
            name in qctx.deploy:
        iw = qctx.deploy[name]
        out_dtype = x.dtype
        x = _deployed_act(qctx, name, x)
        if isinstance(iw, int_ops.FPWeight):
            return fnn.linear(x, iw.w.to(out_dtype), b)
        if isinstance(iw, Int4Weight):
            lead = x.shape[:-1]
            out = int4_kernels.int4_linear(
                x.reshape(-1, iw.k).float().contiguous(), iw.w_packed,
                iw.delta, iw.zp_c, bias=b)
            return out.reshape(lead + (iw.n,)).to(out_dtype)
        raise NotImplementedError(
            f"{name}: deployed {type(iw).__name__} linear needs the int8 "
            "deployment (without --int4-serving), not ported yet")
    if qctx is not None:
        x = qctx.qact(name, x)
        w = qctx.qweight(name, w)
    return fnn.linear(x, w, b)


def qact(qctx: Optional[QuantCtx], name: str,
         x: torch.Tensor) -> torch.Tensor:
    """Standalone activation quant site."""
    if qctx is None:
        return x
    return qctx.qact(name, x)
