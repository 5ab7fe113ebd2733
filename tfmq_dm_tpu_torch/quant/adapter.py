"""Model adapter: what the calibration and deployment code needs to know of
a model (port of ``tfmq_dm_tpu/quant/adapter.py``). This slice needs the
policy and the full forward; the reconstruction units wait for the
calibration slice."""

from __future__ import annotations

import dataclasses
from typing import Callable

from .policy import QuantPolicy


@dataclasses.dataclass(eq=False)
class ModelAdapter:
    policy: QuantPolicy
    # forward(params, ctx, x, t) -> model output (ctx may be None)
    forward: Callable
