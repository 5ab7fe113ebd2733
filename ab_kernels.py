"""A/B timing of ``int4_linear`` and ``flash_fqk`` against another checkout
of the port, on one card, in one process.

    python3 ab_kernels.py --other DIR [--rounds N]

``DIR`` is the root of another checkout of this repository (for example
``git archive <commit> tfmq_dm_tpu_torch | tar -x -C DIR``). Its
``tfmq_dm_tpu_torch`` is imported under another name and builds its
kernels from its own sources into its own ``_build/``. Each shape is timed
in turns, other, this, this, other, ``N`` rounds (default 1): device time
per call, 20 calls captured in one CUDA graph and timed with CUDA events.
The two outputs are compared (largest absolute difference; 0 where both
round the same).

The shapes, modes and inputs are ``chip_smoke.py``'s timed ones
(``timed_linear_shapes``, ``linear_case``, ``FQK_SHAPES``, ``FQK_MODES``,
``fqk_args``). Prints the card's name and power limit, one line per shape
and a JSON line with every time.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

import chip_smoke as S
from tfmq_dm_tpu_torch.configs.tasks import get_task
from tfmq_dm_tpu_torch.ops import flash_attention as FA
from tfmq_dm_tpu_torch.ops import int4_kernels as K
from tfmq_dm_tpu_torch.ops.nn import exact_f32
from tfmq_dm_tpu_torch.utils.timing import device_ms


def load_other(root: Path, name: str = "tfmq_other_port"):
    """``root``'s ``tfmq_dm_tpu_torch`` as package ``name``; returns its
    int4 and flash modules."""
    pkg = root / "tfmq_dm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.int4_kernels"),
            importlib.import_module(f"{name}.ops.flash_attention"))


def ab(fn_other, fn_this, rounds: int) -> dict:
    """Device ms of each, timed other, this, this, other per round, and
    the largest absolute difference of their outputs."""
    t_o, t_t = [], []
    for _ in range(rounds):
        t_o.append(device_ms(fn_other))
        t_t.append(device_ms(fn_this))
        t_t.append(device_ms(fn_this))
        t_o.append(device_ms(fn_other))
    diff = float((fn_other().float() - fn_this().float()).abs().max())
    return {"other_ms": sum(t_o) / len(t_o), "this_ms": sum(t_t) / len(t_t),
            "other_runs": t_o, "this_runs": t_t, "max_abs_diff": diff}


def report(label: str, r: dict) -> None:
    print(f"{label}: other {r['other_ms']:.4f} ms, this {r['this_ms']:.4f} "
          f"ms ({r['other_ms'] / r['this_ms']:.2f}x); max abs diff "
          f"{r['max_abs_diff']:.3e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs an NVIDIA card")
    exact_f32()
    dev = torch.device("cuda")
    oK, oFA = load_other(args.other.resolve())
    for mod in (oK, oFA, K, FA):
        mod.build()
    smi = S.nvidia_smi()
    print(smi, flush=True)
    out = {"card": smi, "int4_linear": [], "flash_fqk": []}
    g = torch.Generator().manual_seed(0)
    _, cin_linears = S.cin_geometries(get_task("cin256_v2").unet)
    for (m, k, n) in S.timed_linear_shapes(cin_linears):
        x = S.linear_case(g, m, k, n, dev)
        r = ab(lambda: oK.int4_linear(*x), lambda: K.int4_linear(*x),
               args.rounds)
        r["shape"] = [m, k, n]
        out["int4_linear"].append(r)
        report(f"int4_linear M{m} {k}->{n}", r)
    for label, bh, t, d in S.FQK_SHAPES:
        for mode in S.FQK_MODES:
            a = S.fqk_args(g, bh, t, d, mode, dev)
            r = ab(lambda: oFA.flash_fqk(*a), lambda: FA.flash_fqk(*a),
                   args.rounds)
            r.update(shape=[bh, t, d], mode=mode)
            out["flash_fqk"].append(r)
            report(f"flash_fqk {label} bh{bh} T{t} d{d} {mode}", r)
            del a
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
