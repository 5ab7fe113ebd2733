"""Quantized call-site wrappers (port of ``tfmq_dm_tpu/quant/qfunc.py``).

Each quantizable op goes through one of these with its unique layer name:
optional input fake-quant -> (quantized or FP) weight -> conv/linear. In
deploy mode (``qctx.deploy``) the call sites execute the deployed weights,
with the outputs in ``qctx.act_out_dtype`` (default: the input's dtype):

- int8 codes with a live 8-bit act grid: the exact ``int_ops.int8_conv2d``
  / ``int8_linear`` on quantized activations (every stride and padding);
- packed 4-bit weights: ``int4_conv2d`` for stride-1 SAME/VALID convs and
  ``int4_linear``, activations fake-quantized elementwise; other convs on
  the dequantized weights;
- weight-only sites, act grids wider than 8 bits and >8-bit weight grids
  (``FPWeight``): an fp conv/linear on dequantized weights.

The kernels dispatch on the tensor's device (CUDA: the hand-written
kernel; CPU: its plain version).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import int4_kernels, int8_kernels, int_ops
from ..ops import nn as fnn
from .context import QuantCtx
from .deploy import Int4ConvWeight, Int4Weight, dequant_int4_conv
from .quantizer import fake_quant


def _fq_input(pol, ast, x):
    """Fake-quantize a deployed layer's input when its act site is
    live."""
    return x if ast is None else fake_quant(x, ast["delta"], ast["zp"],
                                            pol.a_cfg)


def _f32(b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if b is None else b.float()


def _deployed(qctx, name):
    """(deployed weight, policy, live act state or None)."""
    iw = qctx.deploy[name]
    pol = qctx.policy.get(name)
    ast = qctx.astate.get(name) if qctx.use_aq and pol.aq else None
    return iw, pol, ast


def qconv2d(qctx: Optional[QuantCtx], name: str, x: torch.Tensor,
            params: dict, stride: int = 1, padding="SAME") -> torch.Tensor:
    w, b = params["w"], params.get("b")
    if qctx is not None and qctx.deploy is not None and \
            name in qctx.deploy:
        iw, pol, ast = _deployed(qctx, name)
        out_dtype = qctx.act_out_dtype or x.dtype
        if isinstance(iw, int_ops.FPWeight):
            return fnn.conv2d(_fq_input(pol, ast, x), iw.w.to(out_dtype), b,
                              stride=stride, padding=padding)
        if isinstance(iw, Int4ConvWeight):
            x = _fq_input(pol, ast, x)
            if stride == 1 and padding in ("SAME", "VALID"):
                out = int4_kernels.int4_conv2d(
                    x.to(torch.bfloat16).contiguous(), iw.w_packed,
                    iw.delta, iw.zp_c, iw.kh, iw.kw, bias=_f32(b),
                    padding=padding)
                return out.to(out_dtype)
            return fnn.conv2d(x, dequant_int4_conv(iw, out_dtype), b,
                              stride=stride, padding=padding)
        kh, kw = iw.w_q.shape[:2]
        pads = int8_kernels.conv_pads(padding, kh, kw)
        if qctx.shape_tape is not None:
            qctx.shape_tape[name] = (tuple(x.shape[1:3]), stride, pads)
        if ast is not None and int_ops.fits_int8(pol.a_cfg):
            x_q, zp_xc = int_ops.quantize_act_int8(x, ast["delta"],
                                                   ast["zp"], pol.a_cfg)
            return int_ops.int8_conv2d(x_q, zp_xc, ast["delta"], iw, b,
                                       stride=stride, pads=pads,
                                       out_dtype=out_dtype)
        # a wide act grid (codes don't fit int8) or a weight-only site:
        # dequantized weights
        return fnn.conv2d(_fq_input(pol, ast, x),
                          int_ops.dequant_weight(iw, out_dtype), b,
                          stride=stride, padding=padding)
    if qctx is not None:
        x = qctx.qact(name, x)
        w = qctx.qweight(name, w)
    return fnn.conv2d(x, w, b, stride=stride, padding=padding)


def qlinear(qctx: Optional[QuantCtx], name: str, x: torch.Tensor,
            params: dict) -> torch.Tensor:
    w, b = params["w"], params.get("b")
    if qctx is not None and qctx.deploy is not None and \
            name in qctx.deploy:
        iw, pol, ast = _deployed(qctx, name)
        out_dtype = qctx.act_out_dtype or x.dtype
        if isinstance(iw, int_ops.FPWeight):
            return fnn.linear(_fq_input(pol, ast, x), iw.w.to(out_dtype), b)
        if isinstance(iw, Int4Weight):
            x = _fq_input(pol, ast, x)
            lead = x.shape[:-1]
            out = int4_kernels.int4_linear(
                x.reshape(-1, iw.k).float().contiguous(), iw.w_packed,
                iw.delta, iw.zp_c, bias=_f32(b))
            return out.reshape(lead + (iw.n,)).to(out_dtype)
        if ast is not None and int_ops.fits_int8(pol.a_cfg):
            x_q, zp_xc = int_ops.quantize_act_int8(x, ast["delta"],
                                                   ast["zp"], pol.a_cfg)
            return int_ops.int8_linear(x_q, zp_xc, ast["delta"], iw, b,
                                       out_dtype=out_dtype)
        return fnn.linear(_fq_input(pol, ast, x),
                          int_ops.dequant_weight(iw, out_dtype), b)
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
