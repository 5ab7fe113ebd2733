"""Quantized-inference wiring: the per-step model callback of the samplers
from a calibration artifact (port of ``tfmq_dm_tpu/quant/inference.py``).

The FSC activation state is one packed array per group; each step selects
its group's row (``fsc.pack_fsc``) instead of swapping state dicts.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .adapter import ModelAdapter
from .context import QuantCtx
from .fsc import pack_fsc, slice_fsc, step_group, unpack_fsc


def make_model_fn(adapter: ModelAdapter, params, wstate: Optional[Dict],
                  astate_batched: Optional[Dict] = None, *,
                  use_wq: bool = True, use_aq: bool = False,
                  group_of_step=None, kv_cache_fn=None) -> Callable:
    """``model_fn(x, t, step, *cond) -> eps`` of the fake-quant model.

    ``group_of_step``: optional map sampler step -> FSC group (identity
    when None; an index past the end is clamped, ``fsc.step_group``).
    ``kv_cache_fn``: optional ``(qctx) -> cache`` building the
    static-context cross-attention K/V (``ldm_unet.build_cross_kv``); it is
    called once with a group-0 context, since the context-fed to_k/to_v
    sites see the same input at every step, and the cache rides the
    closure (inference.py:21-80)."""
    kv_cache = None
    if kv_cache_fn is not None:
        astate0 = slice_fsc(astate_batched, 0) \
            if (use_aq and astate_batched) else {}
        ctx0 = QuantCtx(adapter.policy, wstate=wstate or {},
                        astate=astate0, use_wq=use_wq, use_aq=use_aq,
                        flash=True)
        kv_cache = kv_cache_fn(ctx0)
    packed = pack_fsc(astate_batched) \
        if (use_aq and astate_batched) else None

    def model_fn(x, t, step: int, *cond):
        astate = {}
        if packed is not None:
            flat, spec = packed
            g = step_group(step, group_of_step, flat.shape[0])
            astate = unpack_fsc(flat[g], spec)
        ctx = QuantCtx(adapter.policy, wstate=wstate or {}, astate=astate,
                       use_wq=use_wq, use_aq=use_aq, flash=True)
        if kv_cache is not None:
            return adapter.forward(params, ctx, x, t, *cond,
                                   kv_cache=kv_cache)
        return adapter.forward(params, ctx, x, t, *cond)

    return model_fn
