"""Functional NN primitives over NHWC activations, HWIO conv weights and
(in, out) linear weights: the layouts of ``tfmq_dm_tpu/ops/nn.py``, kept at
the port's public functions so that tests compare like with like.

A float32 convolution on the card goes through cuDNN in TF32 unless told
otherwise; ``exact_f32`` turns TF32 off for convolutions and matrix
products, and the port's entry points call it (the deployed attention's
integer-valued f32 products are exact only in true f32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def exact_f32() -> None:
    """Run float32 convolutions and matrix products in full float32
    (PyTorch's cuDNN default is TF32). Process-wide PyTorch flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """x: (B,H,W,Cin), w: (kh,kw,Cin,Cout). x follows w's dtype. "SAME"
    is stride-1 with an odd kernel (the only SAME use in the models);
    "VALID" pads nothing; ((top, bottom), (left, right)) pads
    explicitly."""
    kh, kw = w.shape[:2]
    if isinstance(padding, (tuple, list)):
        (pt, pb), (pl, pr) = padding
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pad = (0, 0)
    elif padding == "SAME":
        if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("SAME padding: stride 1 and odd kernels only")
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    x = x.to(w.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=pad).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., Cin), w: (Cin, Cout). x follows w's dtype."""
    out = x.to(w.dtype) @ w
    if b is not None:
        out = out + b
    return out


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel-last tensors with the JAX package's one-pass
    statistics: var = E[x^2] - E[x]^2 in f32 (F.group_norm takes two
    passes, which rounds differently)."""
    c = x.shape[-1]
    dt = x.dtype
    xg = x.float().reshape(x.shape[0], -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    m2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    xn = (xg - mean) * torch.rsqrt(var + eps)
    return xn.reshape(x.shape).to(dt) * gamma + beta


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis as the JAX package writes it
    (``ldm_unet._lnorm``: jnp.mean and jnp.var, which compute in f32 for
    bf16 inputs and round their results to the input's dtype)."""
    xf = x.float()
    mu_f = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu_f) ** 2).mean(dim=-1, keepdim=True).to(x.dtype)
    mu = mu_f.to(x.dtype)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU. In bf16 it takes ``jax.nn.gelu``'s form,
    0.5 x erfc(-x sqrt(1/2)), rounded to bf16 at each step as XLA does."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


def geglu(h: torch.Tensor) -> torch.Tensor:
    """GEGLU (attention.py GEGLU): split in two halves, h * gelu(gate)
    with the exact (erf) GELU."""
    h, gate = h.chunk(2, dim=-1)
    return h * gelu(gate)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x). In bf16 the sigmoid is 1 / (1 + exp(-x)) rounded to
    bf16 at each step, where XLA expands the logistic so; torch.sigmoid
    rounds once and differs in a third of bf16 values."""
    if x.dtype != torch.bfloat16:
        return x * torch.sigmoid(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def timestep_embedding_ldm(t: torch.Tensor, dim: int,
                           max_period: float = 10000.0) -> torch.Tensor:
    """OpenAI/LDM variant (diffusionmodules/util.py:151-171):
    freq = exp(-log(1e4) i / half), concat[cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of the DDIM reference
    (ddim/models/diffusion.py:6-24): concat[sin, cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * -(math.log(max_period) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
