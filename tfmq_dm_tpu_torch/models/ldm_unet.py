"""LDM / Stable-Diffusion UNet (OpenAI ``UNetModel``), PyTorch port of
``tfmq_dm_tpu/models/ldm_unet.py``.

Same layouts and names as the JAX package: parameters are a flat dict
``{torch state_dict module path: {"w"[, "b"]} | {"scale", "bias"}}`` with
HWIO conv weights and (in, out) linear weights; activations are NHWC, and
sequences (B, T, C). An explicit :func:`build_structure` descriptor list
mirrors the reference's construction loop; init, forward and the layer
inventory all walk it. Every quantizable call site goes through
:mod:`..quant.qfunc` with its dotted name; the attention act-quant sites
follow QuantBasicTransformerBlock / QuantQKMatMul / QuantSMVMatMul.

Conditioning: none (the unconditional LDM-4 / LDM-8 tasks), cross-attention
context (cin256-v2 class embeddings, SD text), label embeddings
(``num_classes``), and :func:`diffusion_wrapper`'s dispatch over them.
Reconstruction units tap
their boundaries through ``QuantCtx.tap`` (res blocks ``(x, emb_out)``,
attention blocks ``(x,)``, transformer blocks ``(x, context)``, the
``proj_in``/``proj_out`` layers, the upsample convs and the input conv
``(x,)``, each -> out); a tap returns its value unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import attention as attn_ops
from ..ops import nn as fnn
from ..quant import qfunc
from ..quant.context import QuantCtx
from ..quant.policy import LayerInfo


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    image_size: int = 64           # latent resolution
    in_channels: int = 3
    model_channels: int = 224
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)   # ds factors
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    num_heads: int = -1
    num_head_channels: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    legacy: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


def celeba_config() -> LDMUNetConfig:
    """LDM-4 CelebA-HQ / FFHQ (models/ldm/celeba256/config.yaml):
    AttentionBlocks of 32-channel heads at 32x32, 16x16 and 8x8."""
    return LDMUNetConfig(image_size=64, in_channels=3, model_channels=224,
                         out_channels=3, attention_resolutions=(8, 4, 2),
                         channel_mult=(1, 2, 3, 4), num_head_channels=32)


def lsun_beds_config() -> LDMUNetConfig:
    """LDM-4 LSUN-Bedrooms (models/ldm/lsun_beds256/config.yaml)."""
    return LDMUNetConfig(image_size=64, in_channels=3, model_channels=224,
                         out_channels=3, attention_resolutions=(8, 4, 2),
                         channel_mult=(1, 2, 3, 4), num_head_channels=32)


def lsun_churches_config() -> LDMUNetConfig:
    """LDM-8 LSUN-Churches (models/ldm/lsun_churches256/config.yaml):
    KL-f8 latents, scale-shift norm, res blocks that resample."""
    return LDMUNetConfig(image_size=32, in_channels=4, model_channels=192,
                         out_channels=4,
                         attention_resolutions=(1, 2, 4, 8),
                         channel_mult=(1, 2, 2, 4, 4), num_heads=8,
                         use_scale_shift_norm=True, resblock_updown=True)


def cin256_config() -> LDMUNetConfig:
    """class-conditional ImageNet (configs/latent-diffusion/cin256-v2.yaml):
    conditioning enters as cross-attention context from a ClassEmbedder
    (n_classes=1001, embed_dim=512), not via label_emb."""
    return LDMUNetConfig(image_size=64, in_channels=3, model_channels=192,
                         out_channels=3, attention_resolutions=(8, 4, 2),
                         channel_mult=(1, 2, 3, 5), num_heads=1,
                         use_spatial_transformer=True, transformer_depth=1,
                         context_dim=512)


def sd_v1_config() -> LDMUNetConfig:
    """Stable Diffusion v1.x (configs/stable-diffusion/v1-inference.yaml):
    8 heads of 40 / 80 / 160 channels, CLIP context of 768."""
    return LDMUNetConfig(image_size=32, in_channels=4, model_channels=320,
                         out_channels=4, attention_resolutions=(4, 2, 1),
                         channel_mult=(1, 2, 4, 4), num_heads=8,
                         use_spatial_transformer=True, transformer_depth=1,
                         context_dim=768, legacy=False)


def tiny_ldm_config(**kw) -> LDMUNetConfig:
    """CPU-testable miniature of the LDM topology (AttentionBlocks)."""
    d = dict(image_size=8, in_channels=3, model_channels=32,
             out_channels=3, num_res_blocks=1, attention_resolutions=(2,),
             channel_mult=(1, 2), num_head_channels=16)
    d.update(kw)
    return LDMUNetConfig(**d)


def tiny_sd_config(**kw) -> LDMUNetConfig:
    d = dict(image_size=8, in_channels=3, model_channels=32,
             out_channels=3, num_res_blocks=1, attention_resolutions=(2,),
             channel_mult=(1, 2), num_heads=2,
             use_spatial_transformer=True, transformer_depth=1,
             context_dim=24, legacy=False)
    d.update(kw)
    return LDMUNetConfig(**d)


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sub:
    """One sub-module inside a TimestepEmbedSequential."""

    kind: str       # "conv"|"res"|"attn"|"strans"|"down"|"up"
    prefix: str
    c_in: int = 0
    c_out: int = 0
    heads: int = 1
    d_head: int = 0
    depth: int = 0
    updown: int = 0  # res blocks only: 0 none, 1 up, 2 down


def _attn_heads(cfg: LDMUNetConfig, ch: int) -> Tuple[int, int]:
    """(num_heads, dim_head), openaimodel.py:575-583 / 625-632 /
    665-680."""
    if cfg.num_head_channels == -1:
        num_heads = cfg.num_heads
        dim_head = ch // num_heads
    else:
        num_heads = ch // cfg.num_head_channels
        dim_head = cfg.num_head_channels
    if cfg.legacy:
        dim_head = ch // num_heads if cfg.use_spatial_transformer \
            else cfg.num_head_channels
    return num_heads, dim_head


def _make_attn(cfg, prefix, ch) -> Sub:
    heads, d_head = _attn_heads(cfg, ch)
    if cfg.use_spatial_transformer:
        return Sub("strans", prefix, c_in=ch, c_out=ch, heads=heads,
                   d_head=d_head, depth=cfg.transformer_depth)
    return Sub("attn", prefix, c_in=ch, c_out=ch, heads=heads,
               d_head=d_head)


def build_structure(cfg: LDMUNetConfig):
    """(input_groups, middle_group, output_groups) of Sub tuples, the
    construction loop of openaimodel.py:550-720."""
    mc = cfg.model_channels
    inputs: List[Tuple[Sub, ...]] = [
        (Sub("conv", "input_blocks.0.0", cfg.in_channels, mc),)]
    input_chans = [mc]
    ch = mc
    ds = 1
    n = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            subs = [Sub("res", f"input_blocks.{n}.0", ch, mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                subs.append(_make_attn(cfg, f"input_blocks.{n}.1", ch))
            inputs.append(tuple(subs))
            input_chans.append(ch)
            n += 1
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                inputs.append((Sub("res", f"input_blocks.{n}.0", ch, ch,
                                   updown=2),))
            else:
                inputs.append((Sub("down", f"input_blocks.{n}.0", ch,
                                   ch),))
            input_chans.append(ch)
            ds *= 2
            n += 1

    middle = (Sub("res", "middle_block.0", ch, ch),
              _make_attn(cfg, "middle_block.1", ch),
              Sub("res", "middle_block.2", ch, ch))

    outputs: List[Tuple[Sub, ...]] = []
    n = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            subs = [Sub("res", f"output_blocks.{n}.0", ch + ich, mc * mult)]
            ch = mc * mult
            if ds in cfg.attention_resolutions:
                subs.append(_make_attn(cfg, f"output_blocks.{n}.1", ch))
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    subs.append(Sub("res",
                                    f"output_blocks.{n}.{len(subs)}",
                                    ch, ch, updown=1))
                else:
                    subs.append(Sub("up",
                                    f"output_blocks.{n}.{len(subs)}",
                                    ch, ch))
                ds //= 2
            outputs.append(tuple(subs))
            n += 1
    return inputs, middle, tuple(outputs)


def _all_subs(cfg: LDMUNetConfig):
    inputs, middle, outputs = build_structure(cfg)
    for group in list(inputs) + [middle] + list(outputs):
        yield from group


def iter_layers(cfg: LDMUNetConfig):
    """(kind, name, shape) for every parameterized tensor, in torch
    named_modules (definition) order. kinds: linear / linear_nb / conv /
    conv1d / norm / lnorm / embed / conv_fp (skip) / conv_ds (downsample
    op)."""
    mc, ted = cfg.model_channels, cfg.time_embed_dim
    yield ("linear", "time_embed.0", (mc, ted))
    yield ("linear", "time_embed.2", (ted, ted))
    if cfg.num_classes is not None:
        yield ("embed", "label_emb", (cfg.num_classes, ted))

    def emit_res(s: Sub):
        yield ("norm", f"{s.prefix}.in_layers.0", s.c_in)
        yield ("conv", f"{s.prefix}.in_layers.2", (3, 3, s.c_in, s.c_out))
        emb_out = 2 * s.c_out if cfg.use_scale_shift_norm else s.c_out
        yield ("linear", f"{s.prefix}.emb_layers.1", (ted, emb_out))
        yield ("norm", f"{s.prefix}.out_layers.0", s.c_out)
        yield ("conv", f"{s.prefix}.out_layers.3", (3, 3, s.c_out, s.c_out))
        if s.c_in != s.c_out:
            yield ("conv_fp", f"{s.prefix}.skip_connection",
                   (1, 1, s.c_in, s.c_out))

    def emit_attn(s: Sub):
        yield ("norm", f"{s.prefix}.norm", s.c_in)
        yield ("conv1d", f"{s.prefix}.qkv", (s.c_in, 3 * s.c_in))
        yield ("conv1d", f"{s.prefix}.proj_out", (s.c_in, s.c_in))

    def emit_strans(s: Sub):
        inner = s.heads * s.d_head
        yield ("norm", f"{s.prefix}.norm", s.c_in)
        yield ("conv", f"{s.prefix}.proj_in", (1, 1, s.c_in, inner))
        for d in range(s.depth):
            p = f"{s.prefix}.transformer_blocks.{d}"
            yield ("lnorm", f"{p}.norm1", inner)
            yield ("linear_nb", f"{p}.attn1.to_q", (inner, inner))
            yield ("linear_nb", f"{p}.attn1.to_k", (inner, inner))
            yield ("linear_nb", f"{p}.attn1.to_v", (inner, inner))
            yield ("linear", f"{p}.attn1.to_out.0", (inner, inner))
            yield ("lnorm", f"{p}.norm2", inner)
            cd = cfg.context_dim or inner
            yield ("linear_nb", f"{p}.attn2.to_q", (inner, inner))
            yield ("linear_nb", f"{p}.attn2.to_k", (cd, inner))
            yield ("linear_nb", f"{p}.attn2.to_v", (cd, inner))
            yield ("linear", f"{p}.attn2.to_out.0", (inner, inner))
            yield ("lnorm", f"{p}.norm3", inner)
            yield ("linear", f"{p}.ff.net.0.proj", (inner, inner * 8))
            yield ("linear", f"{p}.ff.net.2", (inner * 4, inner))
        yield ("conv", f"{s.prefix}.proj_out", (1, 1, inner, s.c_in))

    for s in _all_subs(cfg):
        if s.kind == "conv":
            yield ("conv", s.prefix, (3, 3, s.c_in, s.c_out))
        elif s.kind == "res":
            yield from emit_res(s)
        elif s.kind == "attn":
            yield from emit_attn(s)
        elif s.kind == "strans":
            yield from emit_strans(s)
        elif s.kind == "down":
            yield ("conv_ds", f"{s.prefix}.op", (3, 3, s.c_in, s.c_out))
        elif s.kind == "up":
            yield ("conv", f"{s.prefix}.conv", (3, 3, s.c_in, s.c_out))
    yield ("norm", "out.0", mc)
    yield ("conv", "out.2", (3, 3, mc, cfg.out_channels))


def iter_layers_with_res(cfg: LDMUNetConfig):
    """(kind, name, shape, res) of :func:`iter_layers`, ``res`` the side of
    the latent the layer writes: a Downsample op halves it and an
    Upsample's conv doubles it; with ``resblock_updown`` a res block
    resamples between its ``in_layers.0`` norm and its ``in_layers.2``
    conv (``updown`` 2 halves, 1 doubles)."""
    resample = {f"{s.prefix}.in_layers.2": s.updown for s in _all_subs(cfg)
                if s.kind == "res" and s.updown}
    res = cfg.image_size
    for kind, name, shape in iter_layers(cfg):
        if kind == "conv_ds" or resample.get(name) == 2:
            res //= 2
        elif (kind == "conv" and name.endswith(".conv")) or \
                resample.get(name) == 1:
            res *= 2
        yield kind, name, shape, res


def init_params(generator: torch.Generator, cfg: LDMUNetConfig,
                device=None) -> Dict[str, dict]:
    """The JAX package's init scheme (norms 1/0, embeddings N(0, 0.02^2),
    weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn with
    ``generator`` on its device (or ``device``)."""
    device = device or generator.device
    params = {}

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return (2.0 * u - 1.0) * bound

    for kind, name, shape in iter_layers(cfg):
        if kind in ("norm", "lnorm"):
            params[name] = {"scale": torch.ones(shape, device=device),
                            "bias": torch.zeros(shape, device=device)}
            continue
        if kind == "embed":
            params[name] = {"w": 0.02 * torch.randn(
                shape, generator=generator, device=device)}
            continue
        fan_in = shape[0] if kind in ("linear", "linear_nb", "conv1d") \
            else shape[0] * shape[1] * shape[2]
        bound = 1.0 / math.sqrt(fan_in)
        entry = {"w": uniform(shape, bound)}
        if kind != "linear_nb":
            entry["b"] = uniform((shape[-1],), bound)
        params[name] = entry
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _norm(p, x):
    return fnn.group_norm(x, p["scale"], p["bias"], groups=32, eps=1e-5)


def _lnorm(p, x):
    return fnn.layer_norm(x, p["scale"], p["bias"], eps=1e-5)


def _res_forward(params, cfg, s: Sub, x, emb_out, qctx):
    """ResBlock._forward (openaimodel.py:255-277) with the emb projection
    computed by the caller (:func:`res_emb_out`; the TIB shares it)."""
    if qctx is not None:
        qctx.tap(s.prefix, "in", (x, emb_out))
    h = fnn.swish(_norm(params[f"{s.prefix}.in_layers.0"], x))
    if s.updown == 1:
        h = fnn.nearest_upsample_2x(h)
        x = fnn.nearest_upsample_2x(x)
    elif s.updown == 2:
        h = fnn.avg_pool_2x(h)
        x = fnn.avg_pool_2x(x)
    h = qfunc.qconv2d(qctx, f"{s.prefix}.in_layers.2", h,
                      params[f"{s.prefix}.in_layers.2"])
    if cfg.use_scale_shift_norm:
        scale, shift = emb_out.chunk(2, dim=-1)
        h = _norm(params[f"{s.prefix}.out_layers.0"], h) \
            * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
    else:
        h = h + emb_out[:, None, None, :]
        h = _norm(params[f"{s.prefix}.out_layers.0"], h)
    h = fnn.swish(h)
    h = qfunc.qconv2d(qctx, f"{s.prefix}.out_layers.3", h,
                      params[f"{s.prefix}.out_layers.3"])
    sc = params.get(f"{s.prefix}.skip_connection")
    if sc is not None:
        x = fnn.conv2d(x, sc["w"], sc.get("b"), padding="VALID")
    out = x + h
    if qctx is not None:
        out = qctx.tap(s.prefix, "out", out)
    return out


def res_emb_out(params, prefix: str, silu_emb, qctx):
    """emb_layers projection, Sequential(SiLU, Linear): the quantized
    linear ``emb_layers.1`` (quant_emb, trained in the TIB)."""
    return qfunc.qlinear(qctx, f"{prefix}.emb_layers.1", silu_emb,
                         params[f"{prefix}.emb_layers.1"])


def _attn_forward(params, s: Sub, x, qctx):
    """AttentionBlock + QKVAttentionLegacy with the QKMatMul/SMVMatMul
    quant sites (openaimodel.py:280-326, 349-405)."""
    if qctx is not None:
        qctx.tap(s.prefix, "in", (x,))
    b, hh, ww, c = x.shape
    t = hh * ww
    xs = x.reshape(b, t, c)
    h_ = _norm(params[f"{s.prefix}.norm"], xs)
    qkv = qfunc.qlinear(qctx, f"{s.prefix}.qkv", h_,
                        params[f"{s.prefix}.qkv"])
    ch = c // s.heads
    q, k, v = qkv.reshape(b, t, s.heads, 3 * ch).chunk(3, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    a = attn_ops.qsm_attention(
        q * scale, k * scale, v, 1.0, qctx,
        {"q": f"{s.prefix}.attention.qkv_matmul.aqtizer_q",
         "k": f"{s.prefix}.attention.qkv_matmul.aqtizer_k",
         "v": f"{s.prefix}.attention.smv_matmul.aqtizer_v",
         "w": f"{s.prefix}.attention.smv_matmul.aqtizer_w"},
        out_dtype=x.dtype)
    h_ = qfunc.qlinear(qctx, f"{s.prefix}.proj_out", a.reshape(b, t, c),
                       params[f"{s.prefix}.proj_out"])
    out = (xs + h_).reshape(b, hh, ww, c)
    if qctx is not None:
        out = qctx.tap(s.prefix, "out", out)
    return out


def _cross_attn(params, prefix: str, x, context, heads: int, d_head: int,
                qctx, kv=None):
    """CrossAttention with the TFMQ act-quant sites (quant_block.py:
    214-245). x: (B,Tq,C); context: (B,Tk,Cd) or None (self-attention).
    ``kv``: precomputed (k, v) of a constant context
    (:func:`build_cross_kv`), in (B,Tk,heads,d_head)."""
    q = qfunc.qlinear(qctx, f"{prefix}.to_q", x, params[f"{prefix}.to_q"])
    b, tq, _ = q.shape
    q = q.reshape(b, tq, heads, d_head)
    if kv is not None:
        k, v = kv
    else:
        ctx = x if context is None else context
        k = qfunc.qlinear(qctx, f"{prefix}.to_k", ctx,
                          params[f"{prefix}.to_k"])
        v = qfunc.qlinear(qctx, f"{prefix}.to_v", ctx,
                          params[f"{prefix}.to_v"])
        tk = k.shape[1]
        k = k.reshape(b, tk, heads, d_head)
        v = v.reshape(b, tk, heads, d_head)
    out = attn_ops.qsm_attention(
        q, k, v, d_head ** -0.5, qctx,
        {"q": f"{prefix}.aqtizer_q", "k": f"{prefix}.aqtizer_k",
         "v": f"{prefix}.aqtizer_v", "w": f"{prefix}.aqtizer_w"},
        out_dtype=x.dtype)
    out = out.reshape(b, tq, heads * d_head)
    return qfunc.qlinear(qctx, f"{prefix}.to_out.0", out,
                         params[f"{prefix}.to_out.0"])


def _transformer_block(params, prefix: str, x, context, heads, d_head,
                       qctx, kv_cache=None):
    """BasicTransformerBlock._forward (attention.py:209-213)."""
    if qctx is not None:
        qctx.tap(prefix, "in", (x, context))
    x = _cross_attn(params, f"{prefix}.attn1",
                    _lnorm(params[f"{prefix}.norm1"], x), None, heads,
                    d_head, qctx) + x
    kv = None if (kv_cache is None or context is None) else \
        kv_cache.get(f"{prefix}.attn2")
    x = _cross_attn(params, f"{prefix}.attn2",
                    _lnorm(params[f"{prefix}.norm2"], x), context, heads,
                    d_head, qctx, kv=kv) + x
    h = _lnorm(params[f"{prefix}.norm3"], x)
    h = qfunc.qlinear(qctx, f"{prefix}.ff.net.0.proj", h,
                      params[f"{prefix}.ff.net.0.proj"])
    h = qfunc.qlinear(qctx, f"{prefix}.ff.net.2", fnn.geglu(h),
                      params[f"{prefix}.ff.net.2"])
    x = h + x
    if qctx is not None:
        x = qctx.tap(prefix, "out", x)
    return x


def _tapped_conv(params, name: str, x, qctx, padding="SAME"):
    """A standalone quantized conv reconstructed as a unit of its own:
    taps ``(x,)`` -> out around it."""
    if qctx is not None:
        qctx.tap(name, "in", (x,))
    x = qfunc.qconv2d(qctx, name, x, params[name], padding=padding)
    if qctx is not None:
        x = qctx.tap(name, "out", x)
    return x


def _strans_forward(params, s: Sub, x, context, qctx, kv_cache=None):
    """SpatialTransformer.forward (attention.py:241-260)."""
    b, hh, ww, _ = x.shape
    h = _norm(params[f"{s.prefix}.norm"], x)
    h = _tapped_conv(params, f"{s.prefix}.proj_in", h, qctx,
                     padding="VALID")
    inner = s.heads * s.d_head
    h = h.reshape(b, hh * ww, inner)
    for d in range(s.depth):
        h = _transformer_block(params, f"{s.prefix}.transformer_blocks.{d}",
                               h, context, s.heads, s.d_head, qctx,
                               kv_cache=kv_cache)
    h = h.reshape(b, hh, ww, inner)
    h = _tapped_conv(params, f"{s.prefix}.proj_out", h, qctx,
                     padding="VALID")
    return h + x


def _downsample(params, s: Sub, x):
    p = params[f"{s.prefix}.op"]
    return fnn.conv2d(x, p["w"], p.get("b"), stride=2,
                      padding=((1, 1), (1, 1)))


def _upsample(params, s: Sub, x, qctx):
    return _tapped_conv(params, f"{s.prefix}.conv",
                        fnn.nearest_upsample_2x(x), qctx)


def time_embedding(params, cfg: LDMUNetConfig, t: torch.Tensor,
                   y: Optional[torch.Tensor] = None,
                   qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """time_embed MLP + optional label embedding (openaimodel.py:744-760).
    Quant sites time_embed.{0,2}."""
    emb = fnn.timestep_embedding_ldm(t, cfg.model_channels)
    emb = qfunc.qlinear(qctx, "time_embed.0", emb, params["time_embed.0"])
    emb = fnn.swish(emb)
    emb = qfunc.qlinear(qctx, "time_embed.2", emb, params["time_embed.2"])
    if cfg.num_classes is not None:
        if y is None:
            raise ValueError("a class-conditional UNet needs labels y")
        emb = emb + params["label_emb"]["w"][y]
    return emb


def tib_forward(params, cfg: LDMUNetConfig, t: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                qctx: Optional[QuantCtx] = None) -> Tuple[torch.Tensor, ...]:
    """Temporal Information Block: time_embed and every emb_layers
    projection (QuantTemporalInformationBlock.forward,
    quant_block.py:101-115)."""
    silu = fnn.swish(time_embedding(params, cfg, t, y, qctx))
    return tuple(qfunc.qlinear(qctx, name, silu, params[name])
                 for _, name, _ in iter_layers(cfg)
                 if name.endswith("emb_layers.1"))


def apply(params: Dict[str, dict], cfg: LDMUNetConfig, x: torch.Tensor,
          t: torch.Tensor, context: Optional[torch.Tensor] = None,
          y: Optional[torch.Tensor] = None,
          qctx: Optional[QuantCtx] = None,
          kv_cache: Optional[Dict[str, tuple]] = None) -> torch.Tensor:
    """UNetModel.forward (openaimodel.py:744-780). x: (B,H,W,C) NHWC;
    t: (B,); context: (B,T,Cd) for cross-attention; y: (B,) labels.
    ``kv_cache``: constant-context cross-attention K/V from
    :func:`build_cross_kv`."""
    emb = time_embedding(params, cfg, t, y, qctx)
    silu_emb = fnn.swish(emb)

    def run_sub(s: Sub, h):
        if s.kind == "conv":
            return _tapped_conv(params, s.prefix, h, qctx)
        if s.kind == "res":
            eo = res_emb_out(params, s.prefix, silu_emb, qctx)
            return _res_forward(params, cfg, s, h, eo, qctx)
        if s.kind == "attn":
            return _attn_forward(params, s, h, qctx)
        if s.kind == "strans":
            return _strans_forward(params, s, h, context, qctx,
                                   kv_cache=kv_cache)
        if s.kind == "down":
            return _downsample(params, s, h)
        if s.kind == "up":
            return _upsample(params, s, h, qctx)
        raise ValueError(s.kind)

    inputs, middle, outputs = build_structure(cfg)
    hs = []
    h = x
    for group in inputs:
        for s in group:
            h = run_sub(s, h)
        hs.append(h)
    for s in middle:
        h = run_sub(s, h)
    for group in outputs:
        h = torch.cat([h, hs.pop()], dim=-1)
        for s in group:
            h = run_sub(s, h)
    h = fnn.swish(_norm(params["out.0"], h))
    return qfunc.qconv2d(qctx, "out.2", h, params["out.2"])


def cross_attn_prefixes(cfg: LDMUNetConfig) -> List[str]:
    """Dotted prefixes of every context-fed cross-attention (attn2) in
    forward order — the keys of a :func:`build_cross_kv` cache."""
    return [f"{s.prefix}.transformer_blocks.{d}.attn2"
            for s in _all_subs(cfg) if s.kind == "strans"
            for d in range(s.depth)]


def build_cross_kv(params: Dict[str, dict], cfg: LDMUNetConfig,
                   context: torch.Tensor,
                   qctx: Optional[QuantCtx] = None) -> Dict[str, tuple]:
    """Every cross-attention K/V projection of a constant context, once
    per prompt batch instead of once per denoising step
    (ldm_unet.py:604-636). Under FSC the callers pass a context sliced to
    one calibration group: the to_k/to_v inputs do not depend on t.
    Returns {attn2_prefix: (k, v)} in (B, Tk, heads, d_head)."""
    cache: Dict[str, tuple] = {}
    b, tk = context.shape[0], context.shape[1]
    for s in _all_subs(cfg):
        if s.kind != "strans":
            continue
        for d in range(s.depth):
            prefix = f"{s.prefix}.transformer_blocks.{d}.attn2"
            k = qfunc.qlinear(qctx, f"{prefix}.to_k", context,
                              params[f"{prefix}.to_k"])
            v = qfunc.qlinear(qctx, f"{prefix}.to_v", context,
                              params[f"{prefix}.to_v"])
            cache[prefix] = (k.reshape(b, tk, s.heads, s.d_head),
                             v.reshape(b, tk, s.heads, s.d_head))
    return cache


def diffusion_wrapper(params: Dict[str, dict], cfg: LDMUNetConfig,
                      conditioning_key: Optional[str], x: torch.Tensor,
                      t: torch.Tensor, c_concat=None, c_crossattn=None,
                      qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """DiffusionWrapper.forward's conditioning dispatch (ddpm.py:1395-1424,
    ldm_unet.py:660-688). ``c_concat`` / ``c_crossattn``: lists of tensors
    (NHWC for concat, (B,T,Cd) for crossattn; adm takes class ids in
    ``c_crossattn[0]``)."""
    if conditioning_key not in (None, "none", "concat", "crossattn",
                                "hybrid", "adm"):
        raise ValueError(f"conditioning key {conditioning_key!r}")
    if conditioning_key in ("concat", "hybrid"):
        x = torch.cat([x] + list(c_concat), dim=-1)
    context = torch.cat(list(c_crossattn), dim=1) \
        if conditioning_key in ("crossattn", "hybrid") else None
    y = c_crossattn[0] if conditioning_key == "adm" else None
    return apply(params, cfg, x, t, context=context, y=y, qctx=qctx)


# ---------------------------------------------------------------------------
# Quantizable call-site inventory (module order)
# ---------------------------------------------------------------------------

def layer_infos(cfg: LDMUNetConfig, use_aq: bool = False
                ) -> List[LayerInfo]:
    """quant_module exclusions (quant_model.py:57-58): no skip_connection,
    no Downsample op; Upsample convs are wrapped; emb_layers.1 tagged
    quant_emb. AttentionBlock matmul sites exist only with ``use_aq``
    (quant_block.py:508-520)."""
    infos: List[LayerInfo] = []
    for kind, name, _ in iter_layers(cfg):
        if kind in ("norm", "lnorm", "embed", "conv_fp", "conv_ds"):
            continue
        infos.append(LayerInfo(
            name=name, kind="conv" if kind == "conv" else "linear",
            quant_emb=name.endswith("emb_layers.1")))
        if name.endswith(".qkv") and use_aq:
            base = name.rsplit(".", 1)[0]
            for site, sm in (("qkv_matmul.aqtizer_q", False),
                             ("qkv_matmul.aqtizer_k", False),
                             ("smv_matmul.aqtizer_w", True),
                             ("smv_matmul.aqtizer_v", False)):
                infos.append(LayerInfo(name=f"{base}.attention.{site}",
                                       kind="act", softmax=sm))
        if name.endswith(".to_v"):
            attn = name.rsplit(".", 1)[0]
            for tag, sm in (("aqtizer_q", False), ("aqtizer_k", False),
                            ("aqtizer_v", False), ("aqtizer_w", True)):
                infos.append(LayerInfo(name=f"{attn}.{tag}", kind="act",
                                       softmax=sm))
    return infos
