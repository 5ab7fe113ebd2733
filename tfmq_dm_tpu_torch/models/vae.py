"""First-stage decoder (VQModel / AutoencoderKL decode), PyTorch port of
the decoder side of ``tfmq_dm_tpu/models/vae.py``. NHWC; the first stage
stays full precision (TFMQ quantizes only the denoising UNet). Parameter
names match the checkpoints' ``first_stage_model.*`` keys. The encoder
waits for a slice that encodes images.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..ops import nn as fnn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """ddconfig subset (e.g. models/ldm/celeba256/config.yaml)."""

    ch: int = 128
    out_ch: int = 3
    in_channels: int = 3
    z_channels: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256
    double_z: bool = False
    # container level:
    embed_dim: int = 3
    vq: bool = True               # VQModelInterface vs AutoencoderKL
    n_embed: int = 8192
    scale_factor: float = 1.0     # LatentDiffusion scale_factor


def sd_vae_config() -> VAEConfig:
    """SD v1.x's AutoencoderKL (KL-f8, v1-inference.yaml first_stage)."""
    return VAEConfig(ch=128, out_ch=3, in_channels=3, z_channels=4,
                     ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                     attn_resolutions=(), resolution=256, double_z=True,
                     embed_dim=4, vq=False, scale_factor=0.18215)


def tiny_vae_config(**kw) -> VAEConfig:
    d = dict(ch=32, out_ch=3, in_channels=3, z_channels=3,
             ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             resolution=16, double_z=False, embed_dim=3, vq=True,
             n_embed=32)
    d.update(kw)
    return VAEConfig(**d)


def _res_shapes(prefix, c_in, c_out):
    yield ("norm", f"{prefix}.norm1", c_in)
    yield ("conv", f"{prefix}.conv1", (3, 3, c_in, c_out))
    yield ("norm", f"{prefix}.norm2", c_out)
    yield ("conv", f"{prefix}.conv2", (3, 3, c_out, c_out))
    if c_in != c_out:
        yield ("conv", f"{prefix}.nin_shortcut", (1, 1, c_in, c_out))


def _attn_shapes(prefix, c):
    yield ("norm", f"{prefix}.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        yield ("conv", f"{prefix}.{n}", (1, 1, c, c))


def iter_decoder_layers(cfg: VAEConfig):
    nres = len(cfg.ch_mult)
    block_in = cfg.ch * cfg.ch_mult[-1]
    curr_res = cfg.resolution // 2 ** (nres - 1)
    yield ("conv", "decoder.conv_in", (3, 3, cfg.z_channels, block_in))
    yield from _res_shapes("decoder.mid.block_1", block_in, block_in)
    yield from _attn_shapes("decoder.mid.attn_1", block_in)
    yield from _res_shapes("decoder.mid.block_2", block_in, block_in)
    for i in reversed(range(nres)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            yield from _res_shapes(f"decoder.up.{i}.block.{j}", block_in,
                                   block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                yield from _attn_shapes(f"decoder.up.{i}.attn.{j}",
                                        block_in)
        if i != 0:
            yield ("conv", f"decoder.up.{i}.upsample.conv",
                   (3, 3, block_in, block_in))
            curr_res *= 2
    yield ("norm", "decoder.norm_out", block_in)
    yield ("conv", "decoder.conv_out", (3, 3, block_in, cfg.out_ch))


def iter_layers(cfg: VAEConfig):
    """Decoder layers and the container's convs and codebook (the JAX
    package's ``iter_layers(cfg, encoder=False)``; ``quant_conv`` belongs
    to encoding and is only carried)."""
    yield from iter_decoder_layers(cfg)
    zc, ed = cfg.z_channels, cfg.embed_dim
    if cfg.vq:
        yield ("conv", "quant_conv", (1, 1, zc, ed))
        yield ("conv", "post_quant_conv", (1, 1, ed, zc))
        yield ("embed", "quantize.embedding", (cfg.n_embed, ed))
    else:
        dzc = 2 * zc if cfg.double_z else zc
        yield ("conv", "quant_conv", (1, 1, dzc, 2 * ed))
        yield ("conv", "post_quant_conv", (1, 1, ed, zc))


def init_params(generator: torch.Generator, cfg: VAEConfig,
                device=None) -> Dict[str, dict]:
    """The JAX package's init scheme (``vae.init_params`` with
    ``encoder=False``), drawn with ``generator``."""
    device = device or generator.device
    params = {}
    for kind, name, shape in iter_layers(cfg):
        if kind == "norm":
            params[name] = {"scale": torch.ones(shape, device=device),
                            "bias": torch.zeros(shape, device=device)}
        elif kind == "embed":
            params[name] = {"w": torch.randn(shape, generator=generator,
                                             device=device) / shape[1]}
        else:
            bound = 1.0 / math.sqrt(shape[0] * shape[1] * shape[2])
            params[name] = {
                "w": (2 * torch.rand(shape, generator=generator,
                                     device=device) - 1) * bound,
                "b": (2 * torch.rand((shape[-1],), generator=generator,
                                     device=device) - 1) * bound}
    return params


def _norm(p, x):
    return fnn.group_norm(x, p["scale"], p["bias"], groups=32, eps=1e-6)


def _conv(params, name, x, padding="SAME"):
    p = params[name]
    return fnn.conv2d(x, p["w"], p.get("b"), padding=padding)


def _res(params, prefix, x):
    h = fnn.swish(_norm(params[f"{prefix}.norm1"], x))
    h = _conv(params, f"{prefix}.conv1", h)
    h = fnn.swish(_norm(params[f"{prefix}.norm2"], h))
    h = _conv(params, f"{prefix}.conv2", h)
    if f"{prefix}.nin_shortcut" in params:
        x = _conv(params, f"{prefix}.nin_shortcut", x, padding="VALID")
    return x + h


def _attn(params, prefix, x):
    """AttnBlock (model.py): single head over H*W tokens, materialized."""
    b, h, w, c = x.shape
    h_ = _norm(params[f"{prefix}.norm"], x)
    q, k, v = (_conv(params, f"{prefix}.{n}", h_, padding="VALID")
               .reshape(b, h * w, c) for n in ("q", "k", "v"))
    attn = torch.softmax((q @ k.transpose(1, 2)) * (c ** -0.5), dim=2)
    o = (attn @ v).reshape(b, h, w, c)
    return x + _conv(params, f"{prefix}.proj_out", o, padding="VALID")


def decoder_apply(params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Decoder.forward. z: (B,h,w,z_channels) NHWC."""
    nres = len(cfg.ch_mult)
    curr_res = cfg.resolution // 2 ** (nres - 1)
    h = _conv(params, "decoder.conv_in", z)
    h = _res(params, "decoder.mid.block_1", h)
    h = _attn(params, "decoder.mid.attn_1", h)
    h = _res(params, "decoder.mid.block_2", h)
    for i in reversed(range(nres)):
        for j in range(cfg.num_res_blocks + 1):
            h = _res(params, f"decoder.up.{i}.block.{j}", h)
            if curr_res in cfg.attn_resolutions:
                h = _attn(params, f"decoder.up.{i}.attn.{j}", h)
        if i != 0:
            h = fnn.nearest_upsample_2x(h)
            h = _conv(params, f"decoder.up.{i}.upsample.conv", h)
            curr_res *= 2
    h = fnn.swish(_norm(params["decoder.norm_out"], h))
    return _conv(params, "decoder.conv_out", h)


def vq_lookup(params, z: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook quantization (VectorQuantizer2,
    autoencoder.py:274-283), the JAX package's distance expression."""
    emb = params["quantize.embedding"]["w"]          # (n_embed, ed)
    flat = z.reshape(-1, z.shape[-1])
    d = ((flat ** 2).sum(dim=1, keepdim=True) - 2.0 * (flat @ emb.T)
         + (emb ** 2).sum(dim=1)[None, :])
    return emb[d.argmin(dim=1)].reshape(z.shape)


def decode(params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """LatentDiffusion.decode_first_stage (ddpm.py:706-743): undo
    scale_factor, (VQ-quantize), post_quant_conv, Decoder."""
    z = z / cfg.scale_factor
    if cfg.vq:
        z = vq_lookup(params, z)
    z = _conv(params, "post_quant_conv", z, padding="VALID")
    return decoder_apply(params, cfg, z)
