"""A/B timing of the redesigned kernels (``int4_linear``, ``flash_fqk``,
``flash_pquant``, the int8 GEMM, ``flash_int8`` and ``flash_fp``) against
another checkout of the port, on one card, in one process.

    python3 ab_kernels.py --other DIR [--rounds N] [--kernels a,b,..]

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
``fqk_args``; ``flash_pquant`` at the 8- and 16-bit softmax grids at
cin256 and SD's 64x64; the int8 GEMM at cin256's ``ff.net.0.proj``
(bf16 out, the weights deployed K-major here and (K, N) in a tree
before the redesign), on the im2col of cin256's 64x64 3x3 192 -> 192
conv and of CIFAR-10's largest conv (int32 out), whose outputs must agree
exactly; ``flash_int8`` with and without the 8-bit softmax quantizer and
``flash_fp`` at cin256 and SD's 64x64, where the two trees' ``flash_int8``
outputs with the quantizer must agree within the one-level rule), and as
controls two kernels that a slice leaves alone, ``int4_conv2d`` at
cin256's 64x64 3x3 192 -> 192 (batch 4) and ``int8_matmul_fused`` at
cin256's ``ff.net.0.proj``. ``--kernels`` picks some of int4_linear,
flash_fqk, flash_pquant, int8_gemm, flash_int8, flash_fp, controls
(default: all). Prints the card's name and power limit, one line per
shape and a JSON line with every time.
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
from tfmq_dm_tpu_torch.models import ddim_unet
from tfmq_dm_tpu_torch.ops import flash_attention as FA
from tfmq_dm_tpu_torch.ops import int4_kernels as K
from tfmq_dm_tpu_torch.ops import int8_kernels as I8
from tfmq_dm_tpu_torch.ops.nn import exact_f32
from tfmq_dm_tpu_torch.utils.timing import device_ms

KERNELS = ("int4_linear", "flash_fqk", "flash_pquant", "int8_gemm",
           "flash_int8", "flash_fp", "controls")


def load_other(root: Path, name: str = "tfmq_other_port"):
    """``root``'s ``tfmq_dm_tpu_torch`` as package ``name``; returns its
    int4, flash and int8 modules."""
    pkg = root / "tfmq_dm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in
                 ("int4_kernels", "flash_attention", "int8_kernels"))


def ab(fn_other, fn_this, rounds: int) -> dict:
    """Device ms of each, timed other, this, this, other per round, and
    the largest absolute difference of their outputs."""
    t_o, t_t = [], []
    for _ in range(rounds):
        t_o.append(device_ms(fn_other))
        t_t.append(device_ms(fn_this))
        t_t.append(device_ms(fn_this))
        t_o.append(device_ms(fn_other))
    a, b = fn_other(), fn_this()
    diff = float((a.float() - b.float()).abs().max())
    return {"other_ms": sum(t_o) / len(t_o), "this_ms": sum(t_t) / len(t_t),
            "other_runs": t_o, "this_runs": t_t, "max_abs_diff": diff,
            "equal": bool(torch.equal(a, b))}


def report(label: str, r: dict) -> None:
    print(f"{label}: other {r['other_ms']:.4f} ms, this {r['this_ms']:.4f} "
          f"ms ({r['other_ms'] / r['this_ms']:.2f}x); max abs diff "
          f"{r['max_abs_diff']:.3e}", flush=True)


def ab_pquant(oFA, g, dev, rounds: int, out: list) -> None:
    """``flash_pquant`` at cin256 and SD's 64x64, 8- and 16-bit grids."""
    for label, bh, t, _, d in (S.FLASH_SHAPES[0], S.FLASH_SHAPES[1]):
        q, k, v = S.flash_case(g, bh, t, t, d, dev)
        for bits, dz_, qr in ((8, S.P_GRIDS[0], (0, 255)),
                              (16, S.P16_GRID, (0, 65535))):
            a = (q, k, v, d ** -0.5, torch.tensor(dz_, device=dev), qr,
                 True)
            r = ab(lambda: oFA.flash_pquant(*a), lambda: FA.flash_pquant(*a),
                   rounds)
            r.update(shape=[bh, t, d], bits=bits)
            out.append(r)
            report(f"flash_pquant {label} bh{bh} T{t} d{d} {bits}-bit", r)
        del q, k, v
        torch.cuda.empty_cache()


def ab_int8(oI8, g, dev, rounds: int, out: list) -> None:
    """The int8 GEMM: cin256's ff.net.0.proj through ``int8_matmul_pre``
    (bf16 out), and the conv GEMMs on an im2col (int32 out), each tree
    with its own weight layout; outputs must be equal."""
    m, k, n = 2 * S.CIN_N * 1024, 384, 3072
    iw = S.int8_weight(g, k, n, False, dev)
    x, zx, dx = S.int8_act(g, (m, k), dev)
    b = torch.randn(n, generator=g).to(dev)
    xs = x.to(torch.int32).sum(-1, keepdim=True).float()
    a = (x, xs, iw.w_q, iw.delta, iw.zp_c, iw.wsum.float(), dx, zx, b)
    r = ab(lambda: oI8.int8_matmul_pre(*a, out_dtype=torch.bfloat16),
           lambda: I8.int8_matmul_pre(*a, out_dtype=torch.bfloat16,
                                      w_t=iw.w_t), rounds)
    r.update(shape=[m, k, n], what="linear, bf16 out")
    out.append(r)
    report(f"int8 GEMM linear M{m} {k}->{n} bf16", r)
    if not r["equal"]:
        raise AssertionError("int8 GEMM: the trees' outputs differ")
    convs, _ = S.cifar_geometries(ddim_unet.cifar10_config())
    res, kh, cin, cout = max(convs, key=lambda c: c[0] ** 2 * c[1] ** 2 *
                             c[2] * c[3])
    for label, bb, res, kh, cin, cout in (
            ("cin256 64x64", 2 * S.CIN_N, 64, 3, 192, 192),
            ("cifar10", S.BATCH, res, kh, cin, cout)):
        iw = S.int8_weight(g, cin, cout, False, dev, kh)
        x, _, _ = S.int8_act(g, (bb, res, res, cin), dev)
        pads = ((kh // 2, kh // 2),) * 2
        cols = I8.im2col(x, kh, kh, 1, pads)
        mc, kc = cols.shape
        w_kn = iw.w_t.t().contiguous()        # (Kp, N), the earlier layout
        r = ab(lambda: oI8._launch("int8_conv2d", cols, w_kn, mc, kc, cout,
                                   1, None),
               lambda: I8._launch("int8_conv2d", cols, iw.w_t, mc, kc, cout,
                                  1, None), rounds)
        r.update(shape=[mc, kc, cout], what=f"{label} conv GEMM, int32 out")
        out.append(r)
        report(f"int8 GEMM {label} conv M{mc} {kc}->{cout} int32", r)
        if not r["equal"]:
            raise AssertionError("int8 GEMM: the trees' outputs differ")


def ab_flash_int8(oFA, g, dev, rounds: int, out: list) -> None:
    """``flash_int8`` at cin256 and SD's 64x64, with the 8-bit softmax
    quantizer (the cin256 int4-serving path's) and without; with it the
    two trees' outputs must agree within the one-level rule."""
    for label, bh, t, _, d in (S.FLASH_SHAPES[0], S.FLASH_SHAPES[1]):
        q, k, v = S.flash_case(g, bh, t, t, d, dev)
        for pw in (S.P_GRIDS[0], None):
            ops, sc = S.int8_case(q, k, v, pw, dev)
            a = (*ops, sc, d ** -0.5, None if pw is None else (0, 255))
            r = ab(lambda: oFA.flash_int8(*a), lambda: FA.flash_int8(*a),
                   rounds)
            mode = "no p" if pw is None else "8-bit p"
            r.update(shape=[bh, t, d], mode=mode)
            out.append(r)
            report(f"flash_int8 {label} bh{bh} T{t} d{d} {mode}", r)
            if pw is not None:
                S.check_one_level(f"flash_int8 {label} {mode}, this vs "
                                  "other", FA.flash_int8(*a),
                                  oFA.flash_int8(*a), pw[0], [])
            del ops, a
        del q, k, v
        torch.cuda.empty_cache()


def ab_flash_fp(oFA, g, dev, rounds: int, out: list) -> None:
    """``flash_fp`` at cin256 and SD's 64x64."""
    for label, bh, t, _, d in (S.FLASH_SHAPES[0], S.FLASH_SHAPES[1]):
        q, k, v = S.flash_case(g, bh, t, t, d, dev)
        r = ab(lambda: oFA.flash_fp(q, k, v, d ** -0.5),
               lambda: FA.flash_fp(q, k, v, d ** -0.5), rounds)
        r.update(shape=[bh, t, d])
        out.append(r)
        report(f"flash_fp {label} bh{bh} T{t} d{d}", r)
        del q, k, v
        torch.cuda.empty_cache()


def ab_controls(oK, oI8, g, dev, rounds: int, out: list) -> None:
    """``int4_conv2d`` at cin256's 64x64 3x3 192 -> 192 (batch 2 x CFG)
    and ``int8_matmul_fused`` at M 4096, 384 -> 3072 (bf16 x and out),
    the same call in both trees."""
    case = S.conv_case(g, 2 * S.CIN_N, 64, 3, 192, 192, dev)
    r = ab(lambda: oK.int4_conv2d(*case), lambda: K.int4_conv2d(*case),
           rounds)
    r.update(shape=[2 * S.CIN_N, 64, 192, 192], what="int4_conv2d")
    out.append(r)
    report(f"int4_conv2d b{2 * S.CIN_N} 64x64 3x3 192->192", r)
    m, kk, n = 2 * S.CIN_N * 1024, 384, 3072
    iw = S.int8_weight(g, kk, n, False, dev)
    x = torch.randn(m, kk, generator=g).to(torch.bfloat16).to(dev)
    a = (x, iw.w_q, iw.delta, iw.zp_c, iw.wsum.float(),
         torch.tensor(0.021, device=dev), torch.tensor(-3.0, device=dev),
         torch.randn(n, generator=g).to(dev))
    r = ab(lambda: oI8.int8_matmul_fused(*a, out_dtype=torch.bfloat16),
           lambda: I8.int8_matmul_fused(*a, out_dtype=torch.bfloat16),
           rounds)
    r.update(shape=[m, kk, n], what="int8_matmul_fused, bf16")
    out.append(r)
    report(f"int8_matmul_fused M{m} {kk}->{n} bf16", r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ", ".join(KERNELS))
    args = ap.parse_args(argv)
    picked = args.kernels.split(",")
    if not set(picked) <= set(KERNELS):
        raise SystemExit(f"ab_kernels: --kernels takes {KERNELS}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs an NVIDIA card")
    exact_f32()
    dev = torch.device("cuda")
    oK, oFA, oI8 = load_other(args.other.resolve())
    for mod in (oK, oFA, oI8, K, FA, I8):
        mod.build()
    smi = S.nvidia_smi()
    print(smi, flush=True)
    out = {"card": smi, **{name: [] for name in picked}}
    g = torch.Generator().manual_seed(0)
    _, cin_linears = S.cin_geometries(get_task("cin256_v2").unet)
    shapes = S.timed_linear_shapes(cin_linears) \
        if "int4_linear" in picked else []
    for (m, k, n) in shapes:
        x = S.linear_case(g, m, k, n, dev)
        r = ab(lambda: oK.int4_linear(*x), lambda: K.int4_linear(*x),
               args.rounds)
        r["shape"] = [m, k, n]
        out["int4_linear"].append(r)
        report(f"int4_linear M{m} {k}->{n}", r)
    for label, bh, t, d in S.FQK_SHAPES if "flash_fqk" in picked else []:
        for mode in S.FQK_MODES:
            a = S.fqk_args(g, bh, t, d, mode, dev)
            r = ab(lambda: oFA.flash_fqk(*a), lambda: FA.flash_fqk(*a),
                   args.rounds)
            r.update(shape=[bh, t, d], mode=mode)
            out["flash_fqk"].append(r)
            report(f"flash_fqk {label} bh{bh} T{t} d{d} {mode}", r)
            del a
            torch.cuda.empty_cache()
    if "flash_pquant" in picked:
        ab_pquant(oFA, g, dev, args.rounds, out["flash_pquant"])
    if "int8_gemm" in picked:
        ab_int8(oI8, g, dev, args.rounds, out["int8_gemm"])
    if "flash_int8" in picked:
        ab_flash_int8(oFA, g, dev, args.rounds, out["flash_int8"])
    if "flash_fp" in picked:
        ab_flash_fp(oFA, g, dev, args.rounds, out["flash_fp"])
    if "controls" in picked:
        ab_controls(oK, oI8, g, dev, args.rounds, out["controls"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
