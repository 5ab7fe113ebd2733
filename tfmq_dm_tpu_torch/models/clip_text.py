"""Conditioning encoders (port of the part of
``tfmq_dm_tpu/models/clip_text.py`` that class-conditional LDM needs).
The CLIP text transformer and its tokenizers wait for the SD slice."""

from __future__ import annotations

import torch


def class_embed(emb_table: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ClassEmbedder for cross-attention conditioning (modules.py:28-33):
    (B,) class ids -> (B, 1, embed_dim)."""
    return emb_table[y][:, None, :]
