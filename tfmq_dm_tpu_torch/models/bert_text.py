"""The BERT text encoder of the LDM text-to-image family, PyTorch port of
``tfmq_dm_tpu/models/bert_text.py``: the reference's ``BERTEmbedder``
(ldm/modules/encoders/modules.py:80-103), the vendored x-transformers
``TransformerWrapper`` over an ``Encoder(dim, depth)``
(ldm/modules/x_transformer.py:548-638, 370-538), which at the reference's
defaults is a pre-LN transformer encoder:

- learned token and absolute position embeddings;
- per layer: LayerNorm -> attention -> residual, LayerNorm ->
  feed-forward -> residual;
- attention with 8 heads of a FIXED ``dim_head`` 64 (inner width 512
  whatever the model width), bias-free q/k/v, a biased output
  projection, non-causal and unmasked;
- feed-forward Linear(dim, 4 dim) -> exact (erf) GELU -> Linear(4 dim,
  dim);
- a final LayerNorm; the logit head is never used for conditioning.

A plain function over a flat parameter dict keyed by the checkpoint's
``cond_stage_model.transformer.*`` names with that prefix stripped, (in,
out) linear weights, in float32. JAX computes this encoder outside any
Pallas kernel, and so does the port: plain ``torch.matmul``.

Tokens: the ``bert-base-uncased`` vocabulary is not part of this
repository, so :func:`tokenize` refuses; callers pass token ids (the
CLI's ``--token_ids``), or use :func:`stub_tokenize`, the JAX package's
deterministic hash tokenizer for the miniature.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..ops import nn as fnn
from . import clip_text


@dataclasses.dataclass(frozen=True)
class BERTTextConfig:
    vocab_size: int = 30522        # bert-base-uncased (modules.py:54)
    dim: int = 1280                # n_embed
    depth: int = 32                # n_layer
    heads: int = 8                 # Attention default (x_transformer.py:220)
    dim_head: int = 64             # DEFAULT_DIM_HEAD, not dim // heads
    max_len: int = 77              # max_seq_len (modules.py:82)
    eps: float = 1e-5              # torch LayerNorm default


def txt2img_1p4b_config() -> BERTTextConfig:
    """configs/latent-diffusion/txt2img-1p4B-eval.yaml:68-71."""
    return BERTTextConfig(dim=1280, depth=32)


def text2img_256_config() -> BERTTextConfig:
    """models/ldm/text2img256/config.yaml:59-62."""
    return BERTTextConfig(dim=640, depth=32)


def tiny_bert_config() -> BERTTextConfig:
    return BERTTextConfig(vocab_size=100, dim=32, depth=2, heads=2,
                          dim_head=8, max_len=16)


# bert-base-uncased's [PAD], [CLS] and [SEP] ids
BERT_PAD, BERT_CLS, BERT_SEP = 0, 101, 102


def iter_layers(cfg: BERTTextConfig):
    """(kind, name, shape) of every learned tensor, in the torch
    ``TransformerWrapper.state_dict()`` naming and JAX's order (layers
    2i: the attention sublayer, 2i + 1: the feed-forward; .0 the
    pre-norm, .1 the block)."""
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    yield ("embed", "token_emb", (cfg.vocab_size, d))
    yield ("embed", "pos_emb.emb", (cfg.max_len, d))
    for i in range(cfg.depth):
        a = f"attn_layers.layers.{2 * i}"
        yield ("lnorm", f"{a}.0", d)
        yield ("linear_nb", f"{a}.1.to_q", (d, inner))
        yield ("linear_nb", f"{a}.1.to_k", (d, inner))
        yield ("linear_nb", f"{a}.1.to_v", (d, inner))
        yield ("linear", f"{a}.1.to_out", (inner, d))
        f = f"attn_layers.layers.{2 * i + 1}"
        yield ("lnorm", f"{f}.0", d)
        yield ("linear", f"{f}.1.net.0.0", (d, 4 * d))
        yield ("linear", f"{f}.1.net.2", (4 * d, d))
    yield ("lnorm", "norm", d)


def init_params(generator: torch.Generator, cfg: BERTTextConfig,
                device=None) -> Dict[str, dict]:
    """The JAX package's init scheme (norms 1/0, embeddings N(0, 0.02^2),
    weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases where the
    layer has one), drawn with ``generator`` on its device (or
    ``device``)."""
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
            params[name] = {"w": (2.0 * u - 1.0) * bound}
            if kind == "linear":
                params[name]["b"] = torch.zeros(shape[-1], device=device)
    return params


def _lin(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def apply(params: Dict[str, dict], cfg: BERTTextConfig,
          input_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) token ids -> embeddings (B, T, dim): the
    ``TransformerWrapper`` forward with ``return_embeddings=True``
    (bert_text.py:126-157), non-causal and unmasked; scores and softmax
    in f32."""
    b, t = input_ids.shape
    ids = input_ids.long()
    x = params["token_emb"]["w"][ids]
    x = x + params["pos_emb.emb"]["w"][:t]
    scale = cfg.dim_head ** -0.5

    def ln(name, h):
        p = params[name]
        return fnn.layer_norm(h, p["scale"], p["bias"], eps=cfg.eps)

    for i in range(cfg.depth):
        a = f"attn_layers.layers.{2 * i}"
        h = ln(f"{a}.0", x)
        q = _lin(params[f"{a}.1.to_q"], h) * scale
        k = _lin(params[f"{a}.1.to_k"], h)
        v = _lin(params[f"{a}.1.to_v"], h)
        q, k, v = (z.reshape(b, t, cfg.heads, cfg.dim_head)
                   for z in (q, k, v))
        sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        o = torch.einsum("bhij,bjhd->bihd", attn.float(), v.float())
        o = o.to(x.dtype).reshape(b, t, cfg.heads * cfg.dim_head)
        x = x + _lin(params[f"{a}.1.to_out"], o)
        f = f"attn_layers.layers.{2 * i + 1}"
        h = ln(f"{f}.0", x)
        h = fnn.gelu(_lin(params[f"{f}.1.net.0.0"], h))
        x = x + _lin(params[f"{f}.1.net.2"], h)
    return ln("norm", x)


def stub_tokenize(texts, cfg: BERTTextConfig) -> torch.Tensor:
    """The JAX package's hash tokenizer, ``clip_text.stub_tokenize``'s
    scheme (bert_text.py:160-165). Not the WordPiece vocabulary."""
    return clip_text.stub_tokenize(texts, cfg)


def empty_prompt_ids(n: int, cfg: BERTTextConfig) -> torch.Tensor:
    """The unconditional row, the tokens of the empty prompt, (n,
    max_len): at bert-base-uncased's vocabulary what its tokenizer gives
    ``""`` under the reference's ``padding="max_length"`` ([CLS], [SEP],
    then [PAD]; no vocabulary file needed), else
    ``stub_tokenize([""])``."""
    if cfg.vocab_size == BERTTextConfig().vocab_size:
        row = torch.full((cfg.max_len,), BERT_PAD, dtype=torch.int64)
        row[0], row[1] = BERT_CLS, BERT_SEP
        return row[None].repeat(n, 1)
    return stub_tokenize([""] * n, cfg)


VOCAB_MISSING = (
    "BERT tokenization needs the bert-base-uncased vocabulary (vocab.txt), "
    "which is not in this repository; pass token ids instead (--token_ids, "
    "an .npy of shape (rows, 77))")


def tokenize(texts, max_length: int = 77):
    """The reference's WordPiece tokenizer (the JAX package loads
    ``bert-base-uncased`` through HF ``BertTokenizerFast``,
    bert_text.py:168-176). Its vocabulary is not in this repository, so
    this refuses (``VOCAB_MISSING``)."""
    raise RuntimeError(VOCAB_MISSING)
