"""Conditioning encoders, PyTorch port of ``tfmq_dm_tpu/models/clip_text.py``:
the CLIP ViT-L/14 text tower that SD v1.x feeds into cross-attention
(the reference's FrozenCLIPEmbedder, ldm/modules/encoders/modules.py:
137-162, which wraps HF ``CLIPTextModel``) and the class embedding of
class-conditional LDM.

The text transformer is a plain function over a flat parameter dict keyed
by the HF ``state_dict`` names (the checkpoint's
``cond_stage_model.transformer.*`` keys with that prefix stripped), with
(in, out) linear weights, returning ``last_hidden_state``: what
``get_learned_conditioning`` hands the UNet. It runs once per prompt batch
in float32.

Tokens: the CLIP BPE vocabulary is not part of this repository, so
:func:`tokenize` refuses; callers pass token ids (the CLI's
``--token_ids``), or use :func:`stub_tokenize`, the JAX package's
deterministic hash tokenizer for the miniature text tasks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict

import numpy as np
import torch

from ..ops import nn as fnn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 77
    eps: float = 1e-5


def vit_l_14_config() -> CLIPTextConfig:
    return CLIPTextConfig()


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=100, width=32, layers=2, heads=4,
                          max_len=16)


# the CLIP tokenizer's start and end-of-text ids; it pads with the latter
CLIP_BOS, CLIP_EOS = 49406, 49407


def iter_layers(cfg: CLIPTextConfig):
    """(kind, name, shape) of every parameter tensor, in HF order."""
    w = cfg.width
    yield ("embed", "text_model.embeddings.token_embedding",
           (cfg.vocab_size, w))
    yield ("embed", "text_model.embeddings.position_embedding",
           (cfg.max_len, w))
    for i in range(cfg.layers):
        p = f"text_model.encoder.layers.{i}"
        yield ("lnorm", f"{p}.layer_norm1", w)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield ("linear", f"{p}.self_attn.{proj}", (w, w))
        yield ("lnorm", f"{p}.layer_norm2", w)
        yield ("linear", f"{p}.mlp.fc1", (w, 4 * w))
        yield ("linear", f"{p}.mlp.fc2", (4 * w, w))
    yield ("lnorm", "text_model.final_layer_norm", w)


def init_params(generator: torch.Generator, cfg: CLIPTextConfig,
                device=None) -> Dict[str, dict]:
    """The JAX package's init scheme (norms 1/0, embeddings N(0, 0.02^2),
    linear weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases), drawn
    with ``generator`` on its device (or ``device``)."""
    device = device or generator.device
    params = {}
    for kind, name, shape in iter_layers(cfg):
        if kind == "lnorm":
            params[name] = {"scale": torch.ones(shape, device=device),
                            "bias": torch.zeros(shape, device=device)}
        elif kind == "embed":
            params[name] = {"w": 0.02 * torch.randn(
                shape, generator=generator, device=device)}
        else:
            bound = 1.0 / math.sqrt(shape[0])
            u = torch.rand(shape, generator=generator, device=device)
            params[name] = {"w": (2.0 * u - 1.0) * bound,
                            "b": torch.zeros(shape[-1], device=device)}
    return params


def _lin(p, x):
    return x @ p["w"] + p["b"]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def apply(params: Dict[str, dict], cfg: CLIPTextConfig,
          input_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) token ids -> last_hidden_state (B, T, width): pre-LN
    transformer with causal self-attention (scores and softmax in f32,
    masked at the dtype's lowest value, as clip_text.py:96-125)."""
    b, t = input_ids.shape
    ids = input_ids.long()
    x = params["text_model.embeddings.token_embedding"]["w"][ids]
    x = x + params["text_model.embeddings.position_embedding"]["w"][:t]
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    neg = torch.finfo(x.dtype).min
    hd = cfg.width // cfg.heads
    scale = hd ** -0.5

    def ln(name, h):
        p = params[name]
        return fnn.layer_norm(h, p["scale"], p["bias"], eps=cfg.eps)

    for i in range(cfg.layers):
        p = f"text_model.encoder.layers.{i}"
        h = ln(f"{p}.layer_norm1", x)
        q = _lin(params[f"{p}.self_attn.q_proj"], h) * scale
        k = _lin(params[f"{p}.self_attn.k_proj"], h)
        v = _lin(params[f"{p}.self_attn.v_proj"], h)
        q, k, v = (a.reshape(b, t, cfg.heads, hd) for a in (q, k, v))
        sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
        sim = sim.masked_fill(~causal, neg)
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        o = torch.einsum("bhij,bjhd->bihd", attn.float(), v.float())
        o = o.to(x.dtype).reshape(b, t, cfg.width)
        x = x + _lin(params[f"{p}.self_attn.out_proj"], o)
        h = ln(f"{p}.layer_norm2", x)
        h = quick_gelu(_lin(params[f"{p}.mlp.fc1"], h))
        x = x + _lin(params[f"{p}.mlp.fc2"], h)
    return ln("text_model.final_layer_norm", x)


def class_embed(emb_table: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ClassEmbedder for cross-attention conditioning (modules.py:28-33):
    (B,) class ids -> (B, 1, embed_dim)."""
    return emb_table[y][:, None, :]


def stub_tokenize(texts, cfg: CLIPTextConfig) -> torch.Tensor:
    """The JAX package's deterministic hash tokenizer (clip_text.py:
    136-150): each lower-cased word -> an md5 bucket in [3, vocab), BOS 1,
    EOS 2, PAD 0. Not the CLIP BPE: a checkpoint trained on CLIP's ids
    reads these ids as other tokens. -> (len(texts), max_len) int64."""
    out = np.zeros((len(texts), cfg.max_len), np.int64)
    for i, text in enumerate(texts):
        ids = [1]
        for wd in str(text).lower().split()[:cfg.max_len - 2]:
            h = int(hashlib.md5(wd.encode()).hexdigest(), 16)
            ids.append(3 + h % (cfg.vocab_size - 3))
        ids.append(2)
        out[i, :len(ids)] = ids
    return torch.from_numpy(out)


def empty_prompt_ids(n: int, cfg: CLIPTextConfig) -> torch.Tensor:
    """The unconditional row, the tokens of the empty prompt, (n,
    max_len): the CLIP tokenizer's ``""`` at CLIP's vocabulary (start,
    then end-of-text as padding; no vocabulary file needed), else
    ``stub_tokenize([""])``."""
    if cfg.vocab_size == vit_l_14_config().vocab_size:
        row = torch.full((cfg.max_len,), CLIP_EOS, dtype=torch.int64)
        row[0] = CLIP_BOS
        return row[None].repeat(n, 1)
    return stub_tokenize([""] * n, cfg)


BPE_FILES_MISSING = (
    "CLIP BPE tokenization needs the openai/clip-vit-large-patch14 "
    "tokenizer files (vocab.json, merges.txt), which are not in this "
    "repository; pass token ids instead (--token_ids, an .npy of shape "
    "(rows, 77))")


def tokenize(texts, max_length: int = 77):
    """The CLIP BPE tokenizer (the JAX package loads
    ``openai/clip-vit-large-patch14`` through HF ``CLIPTokenizer``,
    clip_text.py:153-161). Its vocabulary files are not in this
    repository, so this refuses (``BPE_FILES_MISSING``)."""
    raise RuntimeError(BPE_FILES_MISSING)
