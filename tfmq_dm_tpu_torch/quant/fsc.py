"""FSC — Finite Set Calibration of activation quantizers per timestep
(port of ``tfmq_dm_tpu/quant/fsc.py``, its init pass).

For each timestep group, every activation quantizer is re-initialized
from a small random subset of that group's calibration inputs, in forward
order under the quantized prefix (``running_stat=False``, fsc.py:30-38).
Results are batched tensors ``{site: {delta: (G, ...), zp: (G, ...)}}``.
The running-stat EMA pass waits for the calibration slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .adapter import ModelAdapter
from .context import QuantCtx


@torch.no_grad()
def fsc_calibrate(adapter: ModelAdapter, params, wstate,
                  a_cali_data: Tuple[torch.Tensor, ...],
                  generator: Optional[torch.Generator] = None, *,
                  running_stat: bool = False, init_samples: int = 16,
                  act_scaler: str = "mse") -> Dict:
    """a_cali_data: tuple of group-major tensors, leading dims (G, N, ...)
    — e.g. the output of ``harvest_trajectory`` (steps = groups). The init
    subset of each group is drawn with ``generator`` (a CPU
    ``torch.Generator``)."""
    if running_stat:
        raise NotImplementedError("the FSC running-stat (EMA) pass is not "
                                  "ported yet; use running_stat=False")
    groups, n = a_cali_data[0].shape[:2]
    per_group = []
    for g in range(groups):
        inds = torch.randperm(n, generator=generator)[:min(init_samples, n)]
        batch = tuple(x[g][inds.to(x.device)] for x in a_cali_data)
        ctx = QuantCtx(adapter.policy, wstate=wstate, use_wq=True,
                       use_aq=True, act_mode="init", act_scaler=act_scaler)
        adapter.forward(params, ctx, *batch)
        per_group.append(ctx.out_astate)
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
