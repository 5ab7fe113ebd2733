"""Microbenchmark: the fused GroupNorm + SiLU + int8-quantize kernel
(``ops.gn_kernels.gn_swish_quant_int8``) against the port's unfused chain
(``ops.nn.group_norm`` -> ``ops.nn.swish`` -> ``int_ops.quantize_act_int8``)
at SD v1.4's resblock shapes in bf16; the port's twin of
``scripts/micro_gn.py``.

    python -m tfmq_dm_tpu_torch.scripts.micro_gn [--device cuda|cpu]
        [--shape B,H,W,C ...]

On the card each time is device time per call (20 calls captured in one
CUDA graph, timed with CUDA events); with ``--device cpu`` it is
wall time per call of the plain versions, which says nothing of the card.
Prints one line per shape with both times and their ratio.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops import nn as fnn
from ..ops.gn_kernels import gn_swish_quant_int8
from ..ops.int_ops import quantize_act_int8
from ..quant.quantizer import QCfg
from ..utils.timing import device_ms

SHAPES = ((8, 64, 64, 320), (8, 32, 32, 640), (8, 16, 16, 1280))
GROUPS, EPS = 32, 1e-5
DELTA, ZP = 0.02, 117.0
CFG = QCfg(bits=8, symmetric=False)


def inputs(shape, dev, seed: int = 0):
    """bf16 x ~ N(0, 1), the identity affine and the act grid, all on
    ``dev`` (the grid as tensors: a CUDA graph copies nothing from the
    host)."""
    c = shape[-1]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return (x.to(torch.bfloat16).to(dev), torch.ones(c, device=dev),
            torch.zeros(c, device=dev), torch.tensor(DELTA, device=dev),
            torch.tensor(ZP, device=dev))


def unfused(x, gamma, beta, delta, zp):
    y = fnn.group_norm(x, gamma, beta, groups=GROUPS, eps=EPS)
    return quantize_act_int8(fnn.swish(y), delta, zp, CFG)[0]


def fused(x, gamma, beta, delta, zp):
    return gn_swish_quant_int8(x, gamma, beta, delta, zp, CFG,
                               groups=GROUPS, eps=EPS)[0]


def _cpu_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def time_shape(shape, dev, iters: int = 20) -> dict:
    """ms per call of the unfused chain and of the fused kernel at
    ``shape`` on ``dev``, and their ratio."""
    args = inputs(shape, dev)
    timer = device_ms if dev.type == "cuda" else _cpu_ms
    t_un = timer(lambda: unfused(*args), iters)
    t_fu = timer(lambda: fused(*args), iters)
    return {"shape": tuple(shape), "unfused_ms": t_un, "fused_ms": t_fu,
            "ratio": t_un / t_fu,
            "timer": "device" if dev.type == "cuda" else "cpu wall"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shape", action="append",
                    type=lambda s: tuple(int(v) for v in s.split(",")),
                    help="B,H,W,C (repeatable; default SD v1.4's three)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("micro_gn: no CUDA device (use --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    for shape in args.shape or SHAPES:
        r = time_shape(shape, dev)
        print(f"{r['shape']}: unfused {1e3 * r['unfused_ms']:.1f} us, "
              f"fused {1e3 * r['fused_ms']:.1f} us ({r['ratio']:.2f}x; "
              f"{r['timer']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
