"""Prompt data helpers (the port's copy of the part of
``tfmq_dm_tpu/data/prompts.py`` that the CLI reads)."""

from __future__ import annotations

from typing import List


def prompts_from_file(path: str) -> List[str]:
    """One prompt per line, blank lines skipped (txt2img --from-file)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]
