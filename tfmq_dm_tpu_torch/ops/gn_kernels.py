"""Fused GroupNorm (+ scale-shift) + SiLU + per-tensor int8 activation
quantization: the port's counterpart of ``gn_swish_quant_int8`` in
``tfmq_dm_tpu/ops/pallas_kernels.py`` (``_gn_sq_kernel``).

NHWC x in, centered int8 codes out (the ``int_ops.int8_conv2d`` input
contract), with the one-pass statistics of the Pallas kernel: per-column
f32 sums of x and x^2 folded into groups, var = E[x^2] - E[x]^2. Like the
JAX function, it is for the fast deploy only: its sums run in another
order than ``ops.nn.group_norm``'s, so a code at a rounding boundary may
differ by one level from the unfused chain (``ops.nn.group_norm`` ->
``ops.nn.swish`` -> ``int_ops.quantize_act_int8``), and no exact
deployment calls it.

The kernel is CUDA C++ for ``sm_90a`` (``csrc/gn_kernels.cu``), built with
``nvcc`` into ``_build/`` at first use and called through a plain C
interface with ``ctypes``. The wrapper dispatches on its input's device: a
CPU tensor takes the plain PyTorch version beside it (the tests use it); a
CUDA tensor launches the kernel, or raises. The plain version repeats the
kernel's rounding points (see the source); its sums are taken in
PyTorch's order, so kernel and plain agree to one level on a few codes.
Unlike the Pallas kernel, which asserts that hw is a multiple of
min(hw, 512), both take any hw.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .cuda_build import CudaLibrary, check, launch_check, ptr

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gn_kernels.cu"

# launches of the wrapper since the last reset (chip_smoke.py reads these)
LAUNCHES = {"gn_swish_quant_int8": 0}

# rows of x that one block of the statistics pass sums
ROWS = 64
# channels per group the statistics pass can hold in shared memory
MAX_GROUP_CHANNELS = 6144


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfmq_gn_swish_quant.argtypes = ([p, i] + [p] * 7 + [i] * 5 + [f, f]
                                        + [i] * 5 + [p])
    lib.tfmq_gn_swish_quant.restype = i


LIBRARY = CudaLibrary(SOURCE, _bind)
BUILD_LOG = LIBRARY.log


def build(force: bool = False):
    """Compile ``csrc/gn_kernels.cu`` (once per source content) and load
    it. ``force`` removes its built library first, for a cold build."""
    return LIBRARY.load(force)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _grid(delta, zp, cfg, dev):
    """(delta, zp) as f32 tensors on ``dev``, ``off`` = 2^(bits-1), and
    the clamp bounds."""
    d = torch.as_tensor(delta, dtype=torch.float32, device=dev).reshape(())
    z = torch.as_tensor(zp, dtype=torch.float32, device=dev).reshape(())
    return d, z, 2 ** (cfg.bits - 1), cfg.qrange


def gn_swish_quant_int8_plain(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, delta, zp, cfg, *,
                              groups: int = 32, eps: float = 1e-5,
                              do_swish: bool = True,
                              ss: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None):
    """The kernel's arithmetic in PyTorch ops, at the Pallas kernel's
    rounding points: f32 column sums folded into groups, mean and E[x^2]
    by the f32 reciprocal of n, rsqrt rounded once, the affine folded as
    a = inv gamma (1 + s), bb = (beta - mean a)(1 + s) + t, then
    x a + bb, y sigmoid(y) as y / (1 + exp(-y)), and the per-tensor
    quantization."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // groups
    d, z, off, (nb, pb) = _grid(delta, zp, cfg, x.device)
    xf = x.reshape(b, hw, c).float()
    s1 = xf.sum(1).view(b, groups, cg).sum(-1)
    s2 = (xf * xf).sum(1).view(b, groups, cg).sum(-1)
    inv_n = torch.tensor(1.0 / (hw * cg), dtype=torch.float32)
    mean = s1 * inv_n
    var = torch.clamp(s2 * inv_n - mean * mean, min=0.0)
    inv = torch.rsqrt((var + eps).double()).float()
    a = inv.repeat_interleave(cg, dim=1) * gamma.float()
    bb = beta.float() - mean.repeat_interleave(cg, dim=1) * a
    if ss is not None:
        s1p = 1.0 + ss[0].to(x.dtype).float()
        a = a * s1p
        bb = bb * s1p + ss[1].to(x.dtype).float()
    y = xf * a[:, None] + bb[:, None]
    if do_swish:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    q = torch.clamp(torch.round(y * (1.0 / d)) + z, nb, pb) - off
    return q.to(torch.int8).reshape(x.shape), z - off


def gn_swish_quant_int8(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, delta, zp, cfg, *,
                        groups: int = 32, eps: float = 1e-5,
                        do_swish: bool = True,
                        ss: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None):
    """GroupNorm -> [scale-shift] -> [SiLU] -> per-tensor int8 act
    quantization of NHWC ``x`` (f32 or bf16): (codes int8 (B, H, W, C),
    zp_c = zp - 2^(bits-1) f32). ``ss``: the LDM scale-shift pair, each
    (B, C), rounded to x's dtype as the JAX function does; ``cfg``: the
    activation ``QCfg``."""
    if x.device.type == "cpu":
        return gn_swish_quant_int8_plain(x, gamma, beta, delta, zp, cfg,
                                         groups=groups, eps=eps,
                                         do_swish=do_swish, ss=ss)
    if x.device.type != "cuda":
        raise ValueError(f"gn_swish_quant_int8: unsupported device "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_swish_quant_int8: x dtype {x.dtype}")
    b, h, w, c = x.shape
    if c % groups or c // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"gn_swish_quant_int8: {c} channels in {groups} "
                         "groups")
    dev = x.device
    check("x", x, x.dtype, (b, h, w, c), dev)
    gamma = gamma.to(dev, torch.float32).contiguous()
    beta = beta.to(dev, torch.float32).contiguous()
    check("gamma", gamma, torch.float32, (c,), dev)
    check("beta", beta, torch.float32, (c,), dev)
    ss3 = None
    if ss is not None:
        ss3 = torch.stack([ss[0], ss[1]], dim=1).to(x.dtype).contiguous()
        check("ss", ss3, x.dtype, (b, 2, c), dev)
    d, z, off, (nb, pb) = _grid(delta, zp, cfg, dev)
    sc = torch.stack([d, z])
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out, z - off
    hw = h * w
    part = torch.empty((2, b, -(-hw // ROWS), c), dtype=torch.float32,
                       device=dev)
    ab = torch.empty((2, b, c), dtype=torch.float32, device=dev)
    err = build().tfmq_gn_swish_quant(
        ptr(x), int(x.dtype == torch.bfloat16), ptr(gamma), ptr(beta),
        ptr(ss3), ptr(sc), ptr(part), ptr(ab), ptr(out), b, hw, c, groups,
        ROWS, 1.0 / (hw * (c // groups)), float(eps), nb, pb, off,
        int(do_swish), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    launch_check("gn_swish_quant_int8", err)
    LAUNCHES["gn_swish_quant_int8"] += 1
    return out, z - off
