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
kernel's rounding points (see the source: f32 column sums folded into
groups, mean and E[x^2] by f32(1/n), ``__frsqrt_rn``, the folded affine
rounded product by product, ``expf``, ``rintf``); its sums are taken in
PyTorch's order, so kernel and plain agree to one level on a few codes.
Unlike the Pallas kernel, which asserts that hw is a multiple of
min(hw, 512), both take any hw.

The statistics of a group need the whole batch row before the first code,
and the function is bound by bytes (x read once, the codes written once),
so the kernel keeps x on chip between its two passes, as the TPU kernel
keeps a batch row in VMEM. ``gn_plan`` picks one of two routes from the
shape alone (no fallback: a cluster the card cannot schedule raises):

- ``resident`` (one launch, x read from device memory once): a cluster of
  ``cluster`` blocks (1 to 8) per batch row and slice of ``C /
  slices`` channels (whole groups, rows a multiple of 4 bytes, copied in
  chunks of 16, 8 or 4 bytes) holds that slice of the row in its blocks'
  shared memory, the
  blocks splitting the HW rows; the statistics cross the cluster through
  distributed shared memory. The plan takes it where a slice fits in a
  block's 227 KB (``gn_smem``), choosing the plan whose busiest SM copies
  the fewest bytes of x (the clusters in as few waves as the card
  co-schedules, ``CLUSTER_SLOTS``), then the widest slices, then the
  smallest cluster (a model checked by ``ab_kernels.py --sweep``). Every
  GroupNorm of the port's models and SD's resblocks take it.
- ``stream`` (two launches, x read twice): where no slice fits, a cluster
  of 8 blocks per (batch row, slice) sums x from device memory, reduces
  the statistics across the cluster and writes each channel's affine to a
  (2, B, C) f32 scratch; a second kernel reads x again and writes the
  codes. It takes any C with C / groups <= ``MAX_GROUP_CHANNELS``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .cuda_build import CudaLibrary, check, launch_check, ptr

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gn_kernels.cu"

# launches of the wrapper since the last reset (chip_smoke.py reads these)
LAUNCHES = {"gn_swish_quant_int8": 0}

# threads of a resident block, and of them those that copy and sum x; the
# stream route's statistics block (the source's THREADS, LOADERS,
# STATS_THREADS)
GN_THREADS, GN_LOADERS, GN_STATS_THREADS = 1024, 256, 512
# the card's SMs and the shared memory one block may use (H100)
GN_SMS = 132
SMEM_PER_BLOCK = 232448
# cluster sizes the plan takes (the portable ones), and how many clusters
# of each the card runs at once with one resident block an SM (the
# occupancy query, ``cluster_slots``, on an NVIDIA H100 80GB HBM3: 8-block
# clusters find 15 homes, not 16, so 16 of them would take two waves; a
# card test holds the card to at least these)
CLUSTERS = tuple(range(1, 9))
CLUSTER_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# a wave's fixed latencies (the launch, the first copies landing, the
# folds, the apply's first codes), and a cluster's exchange for each of
# its blocks, as bytes of x a block takes in that time (fitted to
# ab_kernels.py --sweep on an H100: about 7.7 us and 0.16 us, at 0.077 us
# a KB)
WAVE_BYTES, RANK_BYTES = 98304, 2048
# channels of one group the stream route holds: a block's lane sums of a
# one-group slice, 8 bytes a channel, stay within its shared memory
MAX_GROUP_CHANNELS = 16384
# the C function's code for a cluster the card cannot schedule
NO_CLUSTER_FITS = 100000


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfmq_gn_swish_quant.argtypes = ([p, i] + [p] * 9 + [i] * 7 + [f, f]
                                        + [i] * 5 + [p])
    lib.tfmq_gn_swish_quant.restype = i
    lib.tfmq_gn_check_rcp.argtypes = [p, i, p]
    lib.tfmq_gn_check_rcp.restype = i
    lib.tfmq_gn_cluster_slots.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.tfmq_gn_cluster_slots.restype = i


LIBRARY = CudaLibrary(SOURCE, _bind)
BUILD_LOG = LIBRARY.log


def build(force: bool = False):
    """Compile ``csrc/gn_kernels.cu`` (once per source content) and load
    it. ``force`` removes its built library first, for a cold build."""
    return LIBRARY.load(force)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rcp_mismatches(device=None) -> int:
    """On the card: the floats d in [1, 2^126) where the kernel's
    reciprocal of 1 + exp(-y) (rcp.approx and one Newton step) differs
    from the correctly rounded 1 / d, counted against ``__frcp_rn`` and
    against IEEE division (0 when it is exact; the source's rcp_ge1)."""
    dev = torch.device("cuda", torch.cuda.current_device()
                       if device is None else device)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    launch_check("tfmq_gn_check_rcp", build().tfmq_gn_check_rcp(
        ptr(bad), dev.index, torch.cuda.current_stream(dev).cuda_stream))
    return int(bad.item())


def cluster_slots(k: int, smem: int = 200000, device=None) -> int:
    """On the card: how many clusters of ``k`` resident blocks with
    ``smem`` bytes of shared memory each it runs at once (the occupancy
    query that ``CLUSTER_SLOTS`` records)."""
    dev = torch.cuda.current_device() if device is None else device
    n = ctypes.c_int(0)
    launch_check("tfmq_gn_cluster_slots", build().tfmq_gn_cluster_slots(
        k, smem, dev, ctypes.byref(n)))
    return n.value


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def gn_smem(route: str, hw: int, c: int, groups: int, itemsize: int,
            slices: int, cluster: int) -> int:
    """Dynamic shared memory of a statistics block, in bytes (the source's
    ``resident_smem`` / ``stream_smem``): resident, the block's rows of
    its slice of x, each loader lane's column sums of x and x^2, the
    slice's affine parameters, and the group partials and statistics;
    stream, the column sums, partials and statistics."""
    sc = c // slices
    gs = groups // slices
    if route == "resident":
        lanes = GN_LOADERS // (sc * itemsize // copy_bytes(sc, itemsize))
        return -(-hw // cluster) * sc * itemsize + 4 * ((2 * lanes + 4) * sc
                                                        + 4 * gs)
    v = 16 // itemsize if sc * itemsize % 16 == 0 else 1
    lanes = max(1, GN_STATS_THREADS // (sc // v))
    return 4 * (2 * lanes * sc + 4 * gs)


def copy_bytes(sc: int, itemsize: int) -> int:
    """The resident route's copy chunk for a slice of ``sc`` channels: 16
    bytes where its rows allow, else 8, else 4 (the source's CB)."""
    row = sc * itemsize
    return 16 if row % 16 == 0 else 8 if row % 8 == 0 else 4


def _resident_plans(b, hw, c, groups, itemsize):
    for slices in _divisors(groups):
        sc = c // slices
        row = sc * itemsize
        if row % 4 or row // copy_bytes(sc, itemsize) > GN_LOADERS:
            continue
        for k in CLUSTERS:
            if k <= hw and gn_smem("resident", hw, c, groups, itemsize,
                                   slices, k) <= SMEM_PER_BLOCK:
                yield ("resident", slices, k)


def _stream_plan(b, hw, c, groups, itemsize, cluster=8):
    """The stream route's slices: of those whose lane sums fit in shared
    memory and whose rows take 16-byte loads (all that fit, where none
    does), the fewest whose clusters fill the card, else the most."""
    k = min(cluster, hw)
    fit = [s for s in _divisors(groups) if gn_smem(
        "stream", hw, c, groups, itemsize, s, k) <= SMEM_PER_BLOCK]
    cands = [s for s in fit if c // s * itemsize % 16 == 0] or fit
    slices = next((s for s in cands if b * s * k >= GN_SMS), cands[-1])
    return ("stream", slices, k)


def gn_plans(b: int, hw: int, c: int, groups: int, itemsize: int) -> list:
    """Every plan the kernel takes at this shape: each resident plan that
    fits, and the stream route with each cluster size."""
    out = list(_resident_plans(b, hw, c, groups, itemsize))
    return out + sorted({_stream_plan(b, hw, c, groups, itemsize, k)
                         for k in CLUSTERS})


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, hw: int, c: int, groups: int, itemsize: int) -> tuple:
    """(route, slices, cluster) for x (b, hw, c) of ``itemsize`` bytes in
    ``groups`` groups: the resident plan whose busiest SM takes the least
    time, counted as its waves (b * slices clusters, ``CLUSTER_SLOTS`` a
    wave) times ``WAVE_BYTES`` for a wave's latencies, ``RANK_BYTES`` for
    each block of a cluster that exchanges statistics, and a block's
    bytes of x, each slice row of r bytes weighed (r + 32) / r for the
    32-byte sectors it shares with its neighbours; then the widest slices,
    then the smallest cluster. The stream route where no resident plan
    fits."""
    def cost(plan):
        _, slices, k = plan
        waves = -(-b * slices // CLUSTER_SLOTS[k])
        row = c // slices * itemsize
        block = -(-hw // k) * (row + 32)
        return (waves * (WAVE_BYTES + RANK_BYTES * k + block), slices, k)

    plans = list(_resident_plans(b, hw, c, groups, itemsize))
    if plans:
        return min(plans, key=cost)
    return _stream_plan(b, hw, c, groups, itemsize)


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
    activation ``QCfg``. On the card one launch (the resident route) or
    two (the stream route; ``gn_plan``)."""
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
    if x.data_ptr() % 16:              # a view at an odd offset
        x = x.clone()
    gamma = gamma.to(dev, torch.float32).contiguous()
    beta = beta.to(dev, torch.float32).contiguous()
    check("gamma", gamma, torch.float32, (c,), dev)
    check("beta", beta, torch.float32, (c,), dev)
    s = t = None
    if ss is not None:
        s, t = (v.to(dev, x.dtype).contiguous() for v in ss)
        check("ss[0]", s, x.dtype, (b, c), dev)
        check("ss[1]", t, x.dtype, (b, c), dev)
    d, z, off, (nb, pb) = _grid(delta, zp, cfg, dev)
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=dev)
    zp_c = torch.empty((), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, z - off
    hw = h * w
    route, slices, cluster = gn_plan(b, hw, c, groups, x.element_size())
    ab = None if route == "resident" else torch.empty(
        (2, b, c), dtype=torch.float32, device=dev)
    err = build().tfmq_gn_swish_quant(
        ptr(x), int(x.dtype == torch.bfloat16), ptr(gamma), ptr(beta),
        ptr(s), ptr(t), ptr(d), ptr(z), ptr(zp_c), ptr(ab), ptr(out), b, hw,
        c, groups, int(route == "stream"), slices, cluster,
        1.0 / (hw * (c // groups)), float(eps), nb, pb, off, int(do_swish),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err == NO_CLUSTER_FITS:
        raise RuntimeError(f"gn_swish_quant_int8: the card cannot schedule "
                           f"a cluster of {cluster} blocks of the {route} "
                           f"route with {slices} slices")
    launch_check("gn_swish_quant_int8", err)
    LAUNCHES["gn_swish_quant_int8"] += 1
    return out, zp_c
