"""Packed-int4 weight kernels: the port's counterpart of the int4 half of
``tfmq_dm_tpu/ops/pallas_kernels.py``.

- ``int4_linear``  replaces ``int4_matmul_dequant`` (``_int4_mm_kernel``)
- ``int4_conv2d``  replaces ``int4_conv2d_dequant`` (``_int4_conv_kernel``)

Both are CUDA C++ for ``sm_90a`` (``csrc/int4_kernels.cu``), compiled with
``nvcc`` into ``_build/`` at first use and called through a plain C
interface with ``ctypes``. Each wrapper dispatches on the device of its
input: a CPU tensor takes the plain PyTorch version beside it (the tests
use it); a CUDA tensor launches the kernel, or raises. Nothing falls back
from one to the other.

Packing is the port's own: codes in [-8, 7] along the last (output
channel) axis, channel 2j in the low nibble and 2j+1 in the high nibble of
byte j. The TPU's tile-concat layout existed only for its lanes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary, check as _check, \
    launch_check as _launch_check, ptr as _ptr

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "int4_kernels.cu"

# launches of each kernel since the last reset (chip_smoke.py reads these
# to show that the main path went through the kernels)
LAUNCHES = {"int4_linear": 0, "int4_conv2d": 0}


def _bind(lib) -> None:
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tfmq_int4_linear.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.tfmq_int4_linear.restype = i
    lib.tfmq_int4_conv2d.argtypes = [p] * 8 + [i] * 15 + [p]
    lib.tfmq_int4_conv2d.restype = i


LIBRARY = CudaLibrary(SOURCE, _bind)
BUILD_LOG = LIBRARY.log


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """Centered codes (..., N) in [-8, 7] -> uint8 (..., ceil(N/2)); an odd
    last channel is paired with a zero code."""
    w = w_q.to(torch.int16)
    if w.shape[-1] % 2:
        w = F.pad(w, (0, 1))
    lo = w[..., 0::2] & 15
    hi = w[..., 1::2] & 15
    return (lo | (hi << 4)).to(torch.uint8).contiguous()


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: uint8 (..., ceil(n/2)) -> int8 (..., n)."""
    p = packed.to(torch.int16)
    lo = ((p & 15) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).flatten(-2)
    return out[..., :n].to(torch.int8)


def build(force: bool = False):
    """Compile ``csrc/int4_kernels.cu`` (once per source content) and load
    it. ``force`` removes its built library first, for a cold build."""
    return LIBRARY.load(force)


# ---------------------------------------------------------------------------
# int4 linear (counterpart of int4_matmul_dequant)
# ---------------------------------------------------------------------------

def int4_linear_plain(x: torch.Tensor, w_packed: torch.Tensor,
                      delta: torch.Tensor, zp_c: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the kernel's rounding points in PyTorch ops. The
    dequant runs in bf16 arithmetic, rounded at each step as the TPU
    kernel does; products of bf16 values are exact in f32."""
    n = delta.shape[0]
    wq = unpack_int4(w_packed, n).to(torch.bfloat16)
    w = (wq - zp_c.to(torch.bfloat16)) * delta.to(torch.bfloat16)
    out = x.to(torch.bfloat16).float() @ w.float()
    return out if bias is None else out + bias


# block tiles of the two kernel variants (rows of x, K granularity of a
# split); M <= SMALL_M takes the small one
SMALL_M = 64
_TILES = {True: (16, 64, 32), False: (128, 128, 128)}
MAX_SPLITS = 16


def linear_plan(m: int, k: int, n: int, sms: int = 132):
    """(small, kchunk, splits) of ``int4_linear`` on a card with ``sms``
    SMs: the small variant for M <= 64; K split over blocks (partial sums
    added in split order by a second kernel) while the output tiles fill
    under half the SMs, into chunks of whole 32-deep K steps."""
    small = m <= SMALL_M
    bm, bn, min_chunk = _TILES[small]
    tiles = -(-m // bm) * -(-n // bn)
    splits = 1
    if 2 * tiles < sms:
        splits = max(1, min(-(-sms // tiles), k // min_chunk, MAX_SPLITS))
    chunk = -(-(-(-k // splits)) // 32) * 32
    return small, chunk, -(-k // chunk)


_SMS = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index or 0
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def int4_linear(x: torch.Tensor, w_packed: torch.Tensor,
                delta: torch.Tensor, zp_c: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-only int4 GEMM: x (M, K) f32 x packed w (K, ceil(N/2)) ->
    (M, N) f32, with per-channel delta / centered zero point (N,)."""
    if x.device.type == "cpu":
        return int4_linear_plain(x, w_packed, delta, zp_c, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int4_linear: unsupported device {x.device}")
    m, k = x.shape
    n = delta.shape[0]
    dev = x.device
    _check("x", x, torch.float32, (m, k), dev)
    _check("w_packed", w_packed, torch.uint8, (k, (n + 1) // 2), dev)
    _check("delta", delta, torch.float32, (n,), dev)
    _check("zp_c", zp_c, torch.float32, (n,), dev)
    if bias is not None:
        _check("bias", bias, torch.float32, (n,), dev)
    small, chunk, splits = linear_plan(m, k, n, _sm_count(dev))
    lib = build()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tfmq_int4_linear(_ptr(x), _ptr(w_packed), _ptr(delta),
                               _ptr(zp_c), _ptr(bias), _ptr(out), _ptr(ws),
                               m, k, n, int(small), chunk, splits,
                               dev.index or 0, stream)
    _launch_check("int4_linear", err)
    LAUNCHES["int4_linear"] += 1
    return out


# ---------------------------------------------------------------------------
# int4 conv2d (counterpart of int4_conv2d_dequant)
# ---------------------------------------------------------------------------

def _pads(kh: int, kw: int, padding: str):
    if padding == "SAME":
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("SAME padding needs an odd kernel")
        return kh // 2, kw // 2
    if padding == "VALID":
        return 0, 0
    raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def int4_conv2d_plain(x: torch.Tensor, w_packed: torch.Tensor,
                      delta: torch.Tensor, zp_c: torch.Tensor, kh: int,
                      kw: int, bias: Optional[torch.Tensor] = None,
                      padding: str = "SAME") -> torch.Tensor:
    """Plain version: dequant in f32, one rounding to bf16 (the TPU
    kernel's order), then an f32 convolution of the bf16-valued operands
    (exact products, f32 sums)."""
    n = delta.shape[0]
    cin = x.shape[-1]
    ph, pw = _pads(kh, kw, padding)
    wq = unpack_int4(w_packed, n).float()
    w = ((wq - zp_c) * delta).to(torch.bfloat16).float()
    w = w.reshape(kh, kw, cin, n).permute(3, 2, 0, 1)
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=(ph, pw))
    out = out.permute(0, 2, 3, 1)
    return out if bias is None else out + bias


# K steps of the conv: one tap and CONV_BK input channels (mma.sync), or
# CONV_WG_BK (wgmma)
CONV_BK, CONV_WG_BK = 32, 64
# block tiles (BM output pixels x BN output channels) of each route, the
# blocks of each that an SM holds, and their relative rates (output
# elements x K a unit of time) for the plan's cost model, fitted to a
# sweep of every tile and split at every conv geometry of the two
# int4-serving paths on an H100 (PERF.md section 6: ab_kernels.py --sweep)
CONV_TILES = {"mma": ((128, 64), (128, 128)), "wgmma": ((128, 192),)}
CONV_BLOCKS_PER_SM = {"mma": 2, "wgmma": 1}
CONV_RATES = {("mma", 128, 64): 0.8, ("mma", 128, 128): 1.0,
              ("wgmma", 128, 192): 4.5}
# in those units: a split's partial sums, per output element; the wgmma
# route's dequant pre-pass, per weight and per call
CONV_SPLIT_COST = 1.0
CONV_PREPASS_COST = (0.5, 2e6)
# the split counts the plan tries (each range keeps at least 4 steps)
CONV_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def conv_steps(route: str, taps: int, cin: int) -> int:
    """K steps of the conv on ``route``: taps x channel chunks."""
    return taps * -(-cin // (CONV_BK if route == "mma" else CONV_WG_BK))


def conv_plans(m: int, n: int, taps: int, cin: int, sms: int = 132,
               fill: bool = True) -> list:
    """Every (route, bm, bn, splits, spc) ``int4_conv2d`` may take for M
    output pixels, N output channels and K = taps x cin: each route and
    block tile of ``CONV_TILES`` (wgmma only where Cin comes in whole
    64-channel steps), the K steps (``conv_steps``) cut into ``splits``
    ranges of ``spc`` whole steps for each count of ``CONV_SPLITS`` that
    leaves every range at least 4 steps. With ``fill``, K is split only
    while the output tiles fill under half of the blocks the card holds
    (without, the sweep's every plan)."""
    out = []
    for route, tiles in CONV_TILES.items():
        if route == "wgmma" and cin % CONV_WG_BK:
            continue
        steps = conv_steps(route, taps, cin)
        slots = sms * CONV_BLOCKS_PER_SM[route]
        for bm, bn in tiles:
            full = 2 * -(-m // bm) * -(-n // bn) >= slots
            for want in CONV_SPLITS:
                if want > 1 and (steps // want < 4 or (fill and full)):
                    break
                spc = -(-steps // want)
                plan = (route, bm, bn, -(-steps // spc), spc)
                if plan not in out:
                    out.append(plan)
    return out


def conv_cost(plan, m: int, n: int, taps: int, cin: int,
              sms: int = 132) -> float:
    """The plan's modelled time: the waves of blocks
    (``CONV_BLOCKS_PER_SM`` an SM) times a block's steps over its tile's
    rate (``CONV_RATES``), plus the split's partial sums and the wgmma
    route's pre-pass."""
    route, bm, bn, splits, spc = plan
    kstep = CONV_BK if route == "mma" else CONV_WG_BK
    slots = sms * CONV_BLOCKS_PER_SM[route]
    tiles = -(-m // bm) * -(-n // bn)
    cost = -(-tiles * splits // slots) * spc * kstep * bm * bn \
        / CONV_RATES[(route, bm, bn)]
    if splits > 1:
        cost += CONV_SPLIT_COST * splits * m * n
    if route == "wgmma":
        per_weight, per_call = CONV_PREPASS_COST
        cost += per_weight * taps * cin * n + per_call
    return cost


def conv_plan(m: int, n: int, taps: int, cin: int, sms: int = 132):
    """(route, bm, bn, splits, spc) of ``int4_conv2d`` for M = B*Ho*Wo
    output pixels, N output channels and K = taps x cin: of
    ``conv_plans``, the first with the least ``conv_cost``."""
    return min(conv_plans(m, n, taps, cin, sms),
               key=lambda plan: conv_cost(plan, m, n, taps, cin, sms))


def int4_conv2d(x: torch.Tensor, w_packed: torch.Tensor,
                delta: torch.Tensor, zp_c: torch.Tensor, kh: int, kw: int,
                bias: Optional[torch.Tensor] = None,
                padding: str = "SAME") -> torch.Tensor:
    """Stride-1 conv over NHWC bf16 ``x`` with packed-int4 weights
    (kh*kw, Cin, ceil(N/2)) -> (B, Ho, Wo, N) f32."""
    if x.device.type == "cpu":
        return int4_conv2d_plain(x, w_packed, delta, zp_c, kh, kw, bias,
                                 padding)
    if x.device.type != "cuda":
        raise ValueError(f"int4_conv2d: unsupported device {x.device}")
    b, h, w, cin = x.shape
    n = delta.shape[0]
    ph, pw = _pads(kh, kw, padding)
    dev = x.device
    _check("x", x, torch.bfloat16, (b, h, w, cin), dev)
    _check("w_packed", w_packed, torch.uint8,
           (kh * kw, cin, (n + 1) // 2), dev)
    _check("delta", delta, torch.float32, (n,), dev)
    _check("zp_c", zp_c, torch.float32, (n,), dev)
    if bias is not None:
        _check("bias", bias, torch.float32, (n,), dev)
    ho, wo = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    m = b * ho * wo
    route, bm, bn, splits, spc = conv_plan(m, n, kh * kw, cin,
                                           _sm_count(dev))
    lib = build()
    out = torch.empty((b, ho, wo, n), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    # the wgmma route's weights, dequantized by its pre-pass: (N, K) bf16
    wdq = torch.empty((n, kh * kw * cin), dtype=torch.bfloat16, device=dev) \
        if route == "wgmma" else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tfmq_int4_conv2d(_ptr(x), _ptr(w_packed), _ptr(delta),
                               _ptr(zp_c), _ptr(bias), _ptr(out), _ptr(ws),
                               _ptr(wdq), b, h, w, cin, n, kh, kw, ph, pw,
                               int(route == "wgmma"), bm, bn, splits, spc,
                               dev.index or 0, stream)
    _launch_check("int4_conv2d", err)
    LAUNCHES["int4_conv2d"] += 1
    return out
