"""DDIM/DDPM UNet (CIFAR-10 / LSUN class), PyTorch port of
``tfmq_dm_tpu/models/ddim_unet.py``.

Same layouts and names as the JAX package: parameters are a flat dict
``{dotted_name: {"w","b"} | {"scale","bias"}}`` of torch tensors with HWIO
conv weights and (in, out) linear weights; activations are NHWC. Every
quantizable call site goes through :mod:`..quant.qfunc` with its dotted
name. Shortcut and downsample convs are not quant call sites
(quant_model.py:57-58). Reconstruction units tap their boundaries through
``QuantCtx.tap`` (resnet blocks ``(x, temb)`` -> out, attention blocks
``(x,)`` -> out, the upsample convs ``(x,)`` -> out); a tap returns its
value unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import attention as attn_ops
from ..ops import nn as fnn
from ..quant import qfunc
from ..quant.context import QuantCtx
from ..quant.policy import LayerInfo


@dataclasses.dataclass(frozen=True)
class DDIMUNetConfig:
    """cf. ddim/configs/cifar10.yml model section."""

    resolution: int = 32
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resamp_with_conv: bool = True

    @property
    def temb_ch(self) -> int:
        return self.ch * 4

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)


def tiny_config() -> DDIMUNetConfig:
    """A CPU-testable miniature (same topology class as CIFAR-10)."""
    return DDIMUNetConfig(resolution=16, ch=32, ch_mult=(1, 2),
                          num_res_blocks=1, attn_resolutions=(8,))


def cifar10_config() -> DDIMUNetConfig:
    return DDIMUNetConfig()


# ---------------------------------------------------------------------------
# Structure walk: yields (kind, name, shape-info) for init / inventory / io.
# ---------------------------------------------------------------------------

def _resnet_shapes(cfg, prefix, c_in, c_out):
    yield ("norm", f"{prefix}.norm1", c_in)
    yield ("conv", f"{prefix}.conv1", (3, 3, c_in, c_out))
    yield ("linear", f"{prefix}.temb_proj", (cfg.temb_ch, c_out))
    yield ("norm", f"{prefix}.norm2", c_out)
    yield ("conv", f"{prefix}.conv2", (3, 3, c_out, c_out))
    if c_in != c_out:
        yield ("conv_fp", f"{prefix}.nin_shortcut", (1, 1, c_in, c_out))


def _attn_shapes(prefix, c):
    yield ("norm", f"{prefix}.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        yield ("conv", f"{prefix}.{n}", (1, 1, c, c))


def iter_layers(cfg: DDIMUNetConfig):
    """Yield (kind, name, shape) for every parameterized layer, in the same
    order torch's named_modules() walks the reference Model (definition
    order) — this order defines first/last-layer policy indices."""
    ch = cfg.ch
    yield ("linear", "temb.dense.0", (ch, cfg.temb_ch))
    yield ("linear", "temb.dense.1", (cfg.temb_ch, cfg.temb_ch))
    yield ("conv", "conv_in", (3, 3, cfg.in_channels, ch))

    curr_res = cfg.resolution
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    block_in = None
    for i in range(cfg.num_resolutions):
        block_in = ch * in_ch_mult[i]
        block_out = ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            yield from _resnet_shapes(cfg, f"down.{i}.block.{j}",
                                      block_in, block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                yield from _attn_shapes(f"down.{i}.attn.{j}", block_in)
        if i != cfg.num_resolutions - 1:
            if cfg.resamp_with_conv:
                yield ("conv_ds", f"down.{i}.downsample.conv",
                       (3, 3, block_in, block_in))
            curr_res //= 2

    yield from _resnet_shapes(cfg, "mid.block_1", block_in, block_in)
    yield from _attn_shapes("mid.attn_1", block_in)
    yield from _resnet_shapes(cfg, "mid.block_2", block_in, block_in)

    for i in reversed(range(cfg.num_resolutions)):
        block_out = ch * cfg.ch_mult[i]
        skip_in = ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            if j == cfg.num_res_blocks:
                skip_in = ch * in_ch_mult[i]
            yield from _resnet_shapes(cfg, f"up.{i}.block.{j}",
                                      block_in + skip_in, block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                yield from _attn_shapes(f"up.{i}.attn.{j}", block_in)
        if i != 0:
            if cfg.resamp_with_conv:
                yield ("conv_up", f"up.{i}.upsample.conv",
                       (3, 3, block_in, block_in))
            curr_res *= 2

    yield ("norm", "norm_out", block_in)
    yield ("conv", "conv_out", (3, 3, block_in, cfg.out_ch))


def layer_infos(cfg: DDIMUNetConfig) -> List[LayerInfo]:
    """Quantizable call-site inventory in module order, replicating
    quant_model.py:49-66 exclusions: no shortcut convs, no downsample convs
    (upsample convs ARE wrapped); temb_proj tagged quant_emb.
    Attention act sites (aqtizer_q/k/v/w) follow their block's convs,
    cf. QuantAttnBlock (quant_block.py:446-505)."""
    infos: List[LayerInfo] = []
    for kind, name, shape in iter_layers(cfg):
        if kind == "norm" or kind in ("conv_fp", "conv_ds"):
            continue
        base, _, role = name.rpartition(".")
        if name.startswith("temb."):
            unit = "tib"
        elif role in ("conv1", "temb_proj", "conv2") or \
                role in ("q", "k", "v", "proj_out"):
            unit = base  # res / attn unit, e.g. down.0.block.0, mid.attn_1
        else:
            unit = name  # standalone layer unit (conv_in, upsample, conv_out)
        infos.append(LayerInfo(
            name=name,
            kind="linear" if kind == "linear" else "conv",
            quant_emb=name.endswith("temb_proj"),
            unit=unit))
        if name.endswith("proj_out"):
            # act-quant sites inside the attention block, declared after v
            for tag, sm in (("aqtizer_q", False), ("aqtizer_k", False),
                            ("aqtizer_v", False), ("aqtizer_w", True)):
                infos.append(LayerInfo(name=f"{base}.{tag}", kind="act",
                                       softmax=sm, unit=base))
    return infos


def recon_units(cfg: DDIMUNetConfig) -> List[Tuple[str, str]]:
    """(unit_name, unit_kind) in reconstruction DFS order
    (calibration.py:56-84): the TIB first, standalone quant layers as
    'layer' units, resnet and attention blocks as 'res' / 'attn'. conv_in
    and conv_out are listed, but the policy keeps them out of recon."""
    units: List[Tuple[str, str]] = [("tib", "tib")]
    seen = set()
    for kind, name, shape in iter_layers(cfg):
        if kind in ("norm", "conv_fp", "conv_ds") or \
                name.startswith("temb."):
            continue
        base, _, role = name.rpartition(".")
        if role in ("conv1", "temb_proj", "conv2"):
            u = (base, "res")
        elif role in ("q", "k", "v", "proj_out"):
            u = (base, "attn")
        else:
            u = (name, "layer")
        if u[0] not in seen:
            seen.add(u[0])
            units.append(u)
    return units


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _norm(p, x):
    return fnn.group_norm(x, p["scale"], p["bias"], groups=32, eps=1e-6)


def _resnet(params, prefix: str, x, temb, silu_temb,
            qctx: Optional[QuantCtx]):
    """ResnetBlock forward (diffusion.py:115-139); ``silu_temb`` is
    nonlinearity(temb), computed once per forward."""
    if qctx is not None:
        qctx.tap(prefix, "in", (x, temb))
    h = fnn.swish(_norm(params[f"{prefix}.norm1"], x))
    h = qfunc.qconv2d(qctx, f"{prefix}.conv1", h, params[f"{prefix}.conv1"])
    h = h + qfunc.qlinear(qctx, f"{prefix}.temb_proj", silu_temb,
                          params[f"{prefix}.temb_proj"])[:, None, None, :]
    h = fnn.swish(_norm(params[f"{prefix}.norm2"], h))
    h = qfunc.qconv2d(qctx, f"{prefix}.conv2", h, params[f"{prefix}.conv2"])
    sc = params.get(f"{prefix}.nin_shortcut")
    if sc is not None:
        x = fnn.conv2d(x, sc["w"], sc["b"], stride=1, padding="VALID")
    out = x + h
    if qctx is not None:
        out = qctx.tap(prefix, "out", out)
    return out


def _attn(params, prefix: str, x, qctx: Optional[QuantCtx]):
    """AttnBlock forward (diffusion.py:169-194) with the QuantAttnBlock
    act-quant sites (quant_block.py:475-500); single head, H*W flattened
    row-major, ``sm_scale = C**-0.5`` on the dequantized scores."""
    if qctx is not None:
        qctx.tap(prefix, "in", (x,))
    b, h, w, c = x.shape
    h_ = _norm(params[f"{prefix}.norm"], x)
    q = qfunc.qconv2d(qctx, f"{prefix}.q", h_, params[f"{prefix}.q"],
                      padding="VALID")
    k = qfunc.qconv2d(qctx, f"{prefix}.k", h_, params[f"{prefix}.k"],
                      padding="VALID")
    v = qfunc.qconv2d(qctx, f"{prefix}.v", h_, params[f"{prefix}.v"],
                      padding="VALID")
    q = q.reshape(b, h * w, 1, c)
    k = k.reshape(b, h * w, 1, c)
    v = v.reshape(b, h * w, 1, c)
    h_ = attn_ops.qsm_attention(
        q, k, v, c ** -0.5, qctx,
        {"q": f"{prefix}.aqtizer_q", "k": f"{prefix}.aqtizer_k",
         "v": f"{prefix}.aqtizer_v", "w": f"{prefix}.aqtizer_w"},
        out_dtype=x.dtype)
    h_ = h_.reshape(b, h, w, c)
    h_ = qfunc.qconv2d(qctx, f"{prefix}.proj_out", h_,
                       params[f"{prefix}.proj_out"], padding="VALID")
    out = x + h_
    if qctx is not None:
        out = qctx.tap(prefix, "out", out)
    return out


def _downsample(params, prefix, x):
    # torch pads (0,1,0,1) then 3x3 stride-2 VALID (diffusion.py:67-74)
    p = params[f"{prefix}.conv"]
    x = F.pad(x, (0, 0, 0, 1, 0, 1))
    return fnn.conv2d(x, p["w"], p["b"], stride=2, padding="VALID")


def _upsample(params, prefix, x, qctx):
    x = fnn.nearest_upsample_2x(x)
    name = f"{prefix}.conv"
    if qctx is not None:
        qctx.tap(name, "in", (x,))
    x = qfunc.qconv2d(qctx, name, x, params[name])
    if qctx is not None:
        x = qctx.tap(name, "out", x)
    return x


def time_embedding(params, cfg: DDIMUNetConfig, t: torch.Tensor,
                   qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """temb MLP (diffusion.py:310-313). Quant sites temb.dense.{0,1}."""
    temb = fnn.timestep_embedding(t, cfg.ch)
    temb = qfunc.qlinear(qctx, "temb.dense.0", temb, params["temb.dense.0"])
    temb = fnn.swish(temb)
    return qfunc.qlinear(qctx, "temb.dense.1", temb, params["temb.dense.1"])


def tib_forward(params, cfg: DDIMUNetConfig, t: torch.Tensor,
                qctx: Optional[QuantCtx] = None) -> Tuple[torch.Tensor, ...]:
    """Temporal Information Block: the time-embedding MLP and every
    temb_proj, returning the tuple of projections
    (QuantTemporalInformationBlockDDIM.forward, quant_block.py:52-64)."""
    silu = fnn.swish(time_embedding(params, cfg, t, qctx))
    return tuple(qfunc.qlinear(qctx, name, silu, params[name])
                 for kind, name, shape in iter_layers(cfg)
                 if name.endswith("temb_proj"))


def apply(params: Dict[str, dict], cfg: DDIMUNetConfig, x: torch.Tensor,
          t: torch.Tensor, qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """UNet forward (diffusion.py:306-354). x: (B,H,W,C) NHWC; t: (B,)."""
    if not (x.shape[1] == x.shape[2] == cfg.resolution):
        raise ValueError(f"expected {cfg.resolution}x{cfg.resolution} "
                         f"input, got {tuple(x.shape)}")
    if not cfg.resamp_with_conv:
        raise NotImplementedError("resamp_with_conv=False")
    temb = time_embedding(params, cfg, t, qctx)
    silu_temb = fnn.swish(temb)

    hs = [qfunc.qconv2d(qctx, "conv_in", x, params["conv_in"])]
    curr_res = cfg.resolution
    for i in range(cfg.num_resolutions):
        for j in range(cfg.num_res_blocks):
            h = _resnet(params, f"down.{i}.block.{j}", hs[-1], temb,
                        silu_temb, qctx)
            if curr_res in cfg.attn_resolutions:
                h = _attn(params, f"down.{i}.attn.{j}", h, qctx)
            hs.append(h)
        if i != cfg.num_resolutions - 1:
            hs.append(_downsample(params, f"down.{i}.downsample", hs[-1]))
            curr_res //= 2

    h = hs[-1]
    h = _resnet(params, "mid.block_1", h, temb, silu_temb, qctx)
    h = _attn(params, "mid.attn_1", h, qctx)
    h = _resnet(params, "mid.block_2", h, temb, silu_temb, qctx)

    for i in reversed(range(cfg.num_resolutions)):
        for j in range(cfg.num_res_blocks + 1):
            h = _resnet(params, f"up.{i}.block.{j}",
                        torch.cat([h, hs.pop()], dim=-1), temb, silu_temb,
                        qctx)
            if curr_res in cfg.attn_resolutions:
                h = _attn(params, f"up.{i}.attn.{j}", h, qctx)
        if i != 0:
            h = _upsample(params, f"up.{i}.upsample", h, qctx)
            curr_res *= 2

    h = fnn.swish(_norm(params["norm_out"], h))
    return qfunc.qconv2d(qctx, "conv_out", h, params["conv_out"])
