"""FSC — Finite Set Calibration of activation quantizers per timestep
(port of ``tfmq_dm_tpu/quant/fsc.py``).

For each timestep group, every activation quantizer is re-initialized
from a small random subset of that group's calibration inputs, in forward
order under the quantized prefix (fsc.py:30-38); then, with
``running_stat``, a running-stat EMA pass over the whole group in
batches updates each site's range and grid, and the grids after the last
update are kept (fsc.py:40-59). Results are batched tensors
``{site: {delta: (G, ...), zp: (G, ...)}}``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .adapter import ModelAdapter
from .context import QuantCtx

# (group, n) -> (init-subset rows, EMA permutation of n rows or None)
FSCIndexSource = Callable[[int, int],
                          Tuple[torch.Tensor, Optional[torch.Tensor]]]


@torch.no_grad()
def _fsc_init(adapter: ModelAdapter, act_scaler: str, params, wstate,
              batch):
    ctx = QuantCtx(adapter.policy, wstate=wstate, use_wq=True, use_aq=True,
                   act_mode="init", act_scaler=act_scaler)
    adapter.forward(params, ctx, *batch)
    return ctx.out_astate, ctx.out_arange


@torch.no_grad()
def _fsc_ema(adapter: ModelAdapter, momentum: float, batch_size: int,
             params, wstate, arange0, group_data, perm):
    """The running-stat pass over one group: ``n // batch_size`` batches
    in the order of ``perm``; returns the state after the last update."""
    n = group_data[0].shape[0]
    arange, astate = arange0, None
    for i in range(n // batch_size):
        idx = perm[i * batch_size:(i + 1) * batch_size]
        ctx = QuantCtx(adapter.policy, wstate=wstate, use_wq=True,
                       use_aq=True, act_mode="ema", arange=arange,
                       ema_momentum=momentum)
        adapter.forward(params, ctx, *(x[idx] for x in group_data))
        arange, astate = ctx.out_arange, ctx.out_astate
    return astate, arange


def fsc_calibrate(adapter: ModelAdapter, params, wstate,
                  a_cali_data: Tuple[torch.Tensor, ...],
                  generator: Optional[torch.Generator] = None, *,
                  running_stat: bool = True, init_samples: int = 16,
                  batch_size: int = 16, momentum: float = 0.95,
                  act_scaler: str = "mse",
                  indices: Optional[FSCIndexSource] = None) -> Dict:
    """a_cali_data: tuple of group-major tensors, leading dims (G, N, ...)
    — e.g. the output of ``harvest_trajectory`` (steps = groups).

    Per group, the init subset is the first ``init_samples`` of a
    permutation drawn with ``generator`` (a CPU generator); with
    ``running_stat`` (and N >= ``batch_size``) a second permutation
    orders the EMA batches. ``indices(group, n) -> (init rows, EMA
    permutation)`` replaces both draws."""
    groups, n = a_cali_data[0].shape[:2]
    per_group = []
    ema = running_stat and n >= batch_size
    for g in range(groups):
        gdata = tuple(x[g] for x in a_cali_data)
        if indices is not None:
            inds, perm = indices(g, n)
        else:
            inds = torch.randperm(n, generator=generator)[
                :min(init_samples, n)]
            perm = torch.randperm(n, generator=generator) if ema else None
        dev = gdata[0].device
        astate, arange = _fsc_init(adapter, act_scaler, params, wstate,
                                   tuple(x[inds.to(dev)] for x in gdata))
        if ema:
            astate, arange = _fsc_ema(adapter, momentum, batch_size,
                                      params, wstate, arange, gdata,
                                      perm.to(dev))
        per_group.append(astate)
    return {site: {k: torch.stack([pg[site][k] for pg in per_group])
                   for k in per_group[0][site]}
            for site in per_group[0]}


def slice_fsc(astate_batched: Dict, group_index: int) -> Dict:
    """The act state of one timestep group."""
    return {site: {k: v[group_index] for k, v in st.items()}
            for site, st in astate_batched.items()}


def pack_fsc(astate_batched: Dict):
    """Flatten {site: {delta: (G, ...), zp: (G, ...)}} into one (G, L)
    float32 matrix plus an unpack spec, so that a step's state is one row.
    All leaves are small quantizer params, exact in float32."""
    leaves, names = [], []
    for site in sorted(astate_batched):
        for k in sorted(astate_batched[site]):
            leaves.append(astate_batched[site][k])
            names.append((site, k))
    g = leaves[0].shape[0]
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    flat = torch.cat([l.reshape(g, -1).float() for l in leaves], dim=1)
    return flat, (tuple(names), shapes, dtypes)


def unpack_fsc(row: torch.Tensor, spec) -> Dict:
    """Inverse of one packed row: views, reshapes and casts only."""
    names, shapes, dtypes = spec
    out: Dict = {}
    off = 0
    for (site, k), sh, dt in zip(names, shapes, dtypes):
        sz = 1
        for s in sh:
            sz *= s
        out.setdefault(site, {})[k] = row[off:off + sz].reshape(sh).to(dt)
        off += sz
    return out
