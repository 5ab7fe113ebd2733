"""Attention with the four act-quant sites aqtizer_q/k/v/w (port of
``tfmq_dm_tpu/ops/attention.py``, its two non-flash paths).

``softmax(fq(q) fq(k)^T * s) -> fq(softmax) -> @ fq(v)``:

- the deployed path (``_int8_materialized``) computes both products on
  centered integer codes with exact zero-point corrections and the
  (B, H, T, T) score matrix materialized — the JAX package's choice for
  T below its flash gate (CIFAR-10: T = 256);
- the materialized reference path fake-quantizes elementwise (FP
  forwards, calibration).

The integer products are computed as float32 matrix products: every
partial sum of codes is an integer below 2^24 at T, D <= 256
(|q8 k8| <= 128*128*256), so they are exact in true f32 — which is why
the port's entry points turn TF32 off (``ops.nn.exact_f32``). The flash
kernels for T >= 1024 belong to the LDM/SD slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import int_ops


def _site_params(qctx, site):
    """(a_cfg, {delta, zp}) when the act quantizer at ``site`` is live."""
    if qctx is None or site is None or not qctx.use_aq:
        return None
    pol = qctx.policy.get(site)
    st = qctx.astate.get(site)
    if pol is None or not pol.aq or st is None:
        return None
    return pol.a_cfg, st


def _scalar_asym(p) -> bool:
    """Per-tensor scalar grid with uint codes that fit int8 after
    128-centering."""
    if p is None:
        return False
    cfg, st = p
    return (cfg.qrange[0] == 0 and cfg.bits <= 8
            and st["delta"].ndim == 0 and st["zp"].ndim == 0)


def _int8_materialized(q, k, v, sm_scale, pq, pk, pv, pw, out_dtype):
    """fq(a)·fq(b) = da·db·(a8·b8 - zb'·Σa8 - za'·Σb8 + D·za'·zb') with
    centered codes a8 = a_q - 128, z' = z - 128 (attention.py:114-167)."""
    (cq, sq), (ck, sk), (cv, sv) = pq, pk, pv
    q8, zq_c = int_ops.quantize_act_int8(q, sq["delta"], sq["zp"], cq)
    k8, zk_c = int_ops.quantize_act_int8(k, sk["delta"], sk["zp"], ck)
    v8, zv_c = int_ops.quantize_act_int8(v, sv["delta"], sv["zp"], cv)
    q8f, k8f, v8f = q8.float(), k8.float(), v8.float()
    d = q.shape[-1]
    tk = k.shape[1]
    sim = torch.einsum("bihd,bjhd->bhij", q8f, k8f)
    qsum = q8f.sum(dim=-1)
    ksum = k8f.sum(dim=-1)
    sim = (sim
           - zk_c * qsum.permute(0, 2, 1)[:, :, :, None]
           - zq_c * ksum.permute(0, 2, 1)[:, :, None, :]
           + d * zq_c * zk_c)
    scores = (sq["delta"] * sk["delta"] * sm_scale) * sim
    p = torch.softmax(scores, dim=-1)
    dv_ = sv["delta"]
    if pw is not None:
        cw, sw = pw
        dw, zw = sw["delta"], sw["zp"]
        wnb, wpb = cw.qrange
        p_q = torch.clamp(torch.round(p * (1.0 / dw)) + zw, wnb, wpb)
        p8f = p_q - 128.0
        out = torch.einsum("bhij,bjhd->bihd", p8f, v8f)
        psum = p8f.sum(dim=-1)
        vsum = v8f.sum(dim=1)
        out = (dw * dv_) * (out
                            - zv_c * psum.permute(0, 2, 1)[:, :, :, None]
                            + (128.0 - zw) * vsum[:, None, :, :]
                            - (128.0 - zw) * zv_c * float(tk))
        return out.to(out_dtype)
    # no softmax quant: p stays fp, PV on the codes of v with the zero
    # point folded out
    p = p.to(out_dtype)
    out = torch.einsum("bhij,bjhd->bihd", p.float(), v8f)
    psum = p.float().sum(dim=-1)
    out = dv_ * (out - zv_c * psum.permute(0, 2, 1)[:, :, :, None])
    return out.to(out_dtype)


def qsm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float, qctx, sites: Dict[str, Optional[str]],
                  out_dtype=None) -> torch.Tensor:
    """Attention over (B, T, H, D) tensors (H = 1 for the DDIM block).
    ``sites``: {"q","k","v","w"} -> act-quant site names."""
    out_dtype = out_dtype or q.dtype
    pq = _site_params(qctx, sites.get("q"))
    pk = _site_params(qctx, sites.get("k"))
    pv = _site_params(qctx, sites.get("v"))
    pw = _site_params(qctx, sites.get("w"))

    if (qctx is not None and qctx.deploy is not None
            and qctx.act_mode is None
            and all(_scalar_asym(p) for p in (pq, pk, pv))
            and (pw is None or _scalar_asym(pw))):
        return _int8_materialized(q, k, v, sm_scale, pq, pk, pv, pw,
                                  out_dtype)

    # materialized reference path (FP forwards, calibration)
    if qctx is not None:
        if sites.get("q") is not None:
            q = qctx.qact(sites["q"], q)
        if sites.get("k") is not None:
            k = qctx.qact(sites["k"], k)
        if sites.get("v") is not None:
            v = qctx.qact(sites["v"], v)
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * sm_scale
    attn = torch.softmax(sim, dim=-1).to(out_dtype)
    if qctx is not None and sites.get("w") is not None:
        attn = qctx.qact(sites["w"], attn)
    out = torch.einsum("bhij,bjhd->bihd", attn.float(), v.float())
    return out.to(out_dtype)
