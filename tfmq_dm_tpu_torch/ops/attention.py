"""Attention with the four act-quant sites aqtizer_q/k/v/w (port of
``tfmq_dm_tpu/ops/attention.py``).

``softmax(fq(q) fq(k)^T * s) -> fq(softmax) -> @ fq(v)``:

- the flash kernels (``ops/flash_attention.py``) where the key length
  reaches ``MIN_FLASH_KV`` on the card (or ``set_flash("on")``) and the
  context allows it (``QuantCtx.flash``, no act-stat collection, no
  capture tape). When q/k/v carry per-tensor asymmetric 8-bit grids:
  mode fqk in the bf16 fast deploy (deployed context with bf16 carriers:
  q/k/v fake-quantized in the kernel, products of bf16 values), else mode
  int8 (if the softmax grid, if any, fits int8 levels). Otherwise q/k/v
  are fake-quantized elementwise and mode fp or pquant runs;
- the exact deployed path below the flash gate (``_int8_materialized``)
  computes both products on centered integer codes with exact zero-point
  corrections and the (B, H, T, T) score matrix materialized (CIFAR-10:
  T = 256). The fast deploy skips it for the fake-quant path below, with
  bf16 operands and f32 sums (attention.py:258-280);
- the materialized reference path fake-quantizes elementwise (FP
  forwards, calibration, the fast deploy at small T).

``_int8_materialized`` computes its integer products as float32 matrix
products while they are exact there: a partial sum of codes is bounded
by 128 * 128 * max(D, Tk), an integer below 2^24 while max(D, Tk) <= 1024
(cin256: D 960 at T 64), which is why the port's entry points turn TF32
off (``ops.nn.exact_f32``). Above that bound the products are summed
exactly as integers (``int8_kernels.int8_bmm_acc``: the int8 GEMM on the
card, float64 on the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import int8_kernels, int_ops
from .flash_attention import flash_attention

_MODE = "auto"  # "auto" (card, Tk >= MIN_FLASH_KV) | "on" | "off"

# below this key length the materialized score matrix is cheap; the flash
# kernels serve LDM/SD self-attention at 1024-4096 tokens
MIN_FLASH_KV = 1024

# f32 products of int8 codes are exact while 128 * 128 * depth <= 2^24
F32_EXACT_DEPTH = 1024


def set_flash(mode: str) -> None:
    """"auto": flash only for CUDA tensors with Tk >= MIN_FLASH_KV; "on":
    always (the plain versions on the CPU); "off": never."""
    global _MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"flash mode {mode!r}: auto, on or off")
    _MODE = mode


def _flash_ok(qctx, tk: int, device: torch.device) -> bool:
    if _MODE == "off":
        return False
    if _MODE == "auto" and (device.type != "cuda" or tk < MIN_FLASH_KV):
        return False
    if qctx is None:
        return True
    return qctx.flash and qctx.act_mode is None and qctx.capture is None


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


def _scalar_w(p) -> bool:
    """A softmax-output quantizer the flash kernels take: a per-tensor
    grid (any width; only mode int8 needs 8 bits)."""
    if p is None:
        return True
    _, st = p
    return st["delta"].ndim == 0 and st["zp"].ndim == 0


def _fast(qctx) -> bool:
    """The bf16 fast deploy: a deployed context with bf16 carriers."""
    return (qctx is not None and qctx.deploy is not None
            and qctx.act_out_dtype == torch.bfloat16)


def _flash(q, k, v, sm_scale, qctx, sites, pq, pk, pv, pw, out_dtype):
    """The flash dispatch of ``qsm_attention`` (attention.py:184-250)."""
    def bhtd(x):
        return x.permute(0, 2, 1, 3)

    p_quant = (pw[1]["delta"], pw[1]["zp"]) if pw is not None else None
    qrange = pw[0].qrange if pw is not None else None
    p_az = bool(pw is not None and pw[0].always_zero)
    fast = _fast(qctx)
    if all(_scalar_asym(p) for p in (pq, pk, pv)) and (
            fast or pw is None or _scalar_asym(pw)):
        # fast deploy: fqk (in-kernel fake-quant, bf16 products); exact
        # deploy: int8 products with exact corrections
        out = flash_attention(
            bhtd(q), bhtd(k), bhtd(v), sm_scale=sm_scale,
            qkv_quant=tuple((p[1]["delta"], p[1]["zp"])
                            for p in (pq, pk, pv)),
            qkv_ranges=tuple(p[0].qrange for p in (pq, pk, pv)),
            p_quant=p_quant, qrange=qrange, p_always_zero=p_az,
            int8_matmul=not fast)
        return bhtd(out).to(out_dtype)
    # other site configurations (e.g. a 16-bit softmax grid): fake-quant
    # the live q/k/v sites elementwise, then mode fp or pquant
    if qctx is not None:
        if pq is not None:
            q = qctx.qact(sites["q"], q)
        if pk is not None:
            k = qctx.qact(sites["k"], k)
        if pv is not None:
            v = qctx.qact(sites["v"], v)
    out = flash_attention(bhtd(q), bhtd(k), bhtd(v), sm_scale=sm_scale,
                          p_quant=p_quant, qrange=qrange,
                          p_always_zero=p_az)
    return bhtd(out).to(out_dtype)


def _code_product(a: torch.Tensor, b: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """a (Bt, M, K) @ b (Bt, K, N) of int8 codes (as int8 tensors), exact,
    as float32: an f32 product while ``depth`` keeps every partial sum
    below 2^24, else integer sums (``int8_kernels.int8_bmm_acc``)."""
    if depth <= F32_EXACT_DEPTH:
        return a.float() @ b.float()
    return int8_kernels.int8_bmm_acc(a.contiguous(), b.contiguous()).float()


def _int8_materialized(q, k, v, sm_scale, pq, pk, pv, pw, out_dtype):
    """fq(a)·fq(b) = da·db·(a8·b8 - zb'·Σa8 - za'·Σb8 + D·za'·zb') with
    centered codes a8 = a_q - 128, z' = z - 128 (attention.py:114-167)."""
    (cq, sq), (ck, sk), (cv, sv) = pq, pk, pv
    q8, zq_c = int_ops.quantize_act_int8(q, sq["delta"], sq["zp"], cq)
    k8, zk_c = int_ops.quantize_act_int8(k, sk["delta"], sk["zp"], ck)
    v8, zv_c = int_ops.quantize_act_int8(v, sv["delta"], sv["zp"], cv)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    depth = max(d, tk)

    def heads(x):                       # (B, T, H, D) -> (B*H, T, D)
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    sim = _code_product(heads(q8), heads(k8).transpose(1, 2), depth)
    sim = sim.reshape(b, h, tq, tk)
    q8f, k8f, v8f = q8.float(), k8.float(), v8.float()
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
        out = _code_product(p8f.to(torch.int8).reshape(b * h, tq, tk),
                            heads(v8), depth)
        out = out.reshape(b, h, tq, d).permute(0, 2, 1, 3)
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

    if _flash_ok(qctx, k.shape[1], k.device) and _scalar_w(pw):
        return _flash(q, k, v, sm_scale, qctx, sites, pq, pk, pv, pw,
                      out_dtype)

    if (qctx is not None and qctx.deploy is not None and not _fast(qctx)
            and qctx.act_mode is None and qctx.capture is None
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
    # one (B, H, Tq, Tk) map alive at a time: SD's 64x64 self-attention
    # at 32 rows is 17 GB a map (scaled in place, freed once softmaxed)
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
    sim.mul_(sm_scale)
    attn = torch.softmax(sim, dim=-1).to(out_dtype)
    del sim
    if qctx is not None and sites.get("w") is not None:
        attn = qctx.qact(sites["w"], attn)
    out = torch.einsum("bhij,bjhd->bihd", attn.float(), v.float())
    return out.to(out_dtype)
