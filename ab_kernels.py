"""A/B timing of the redesigned kernels (``int4_conv2d``,
``int8_matmul_fused``, ``int4_linear``, ``flash_fqk``, ``flash_pquant``,
the int8 GEMM, ``flash_int8``, ``flash_fp`` and ``gn_swish_quant_int8``)
against another checkout of the port, on one card, in one process.

    python3 ab_kernels.py --other DIR [--rounds N] [--kernels a,b,..]
                          [--sweep] [--other-unchecked]

``DIR`` is the root of another checkout of this repository (for example
``git archive <commit> tfmq_dm_tpu_torch | tar -x -C DIR``). Its
``tfmq_dm_tpu_torch`` is imported under another name and builds its
kernels from its own sources into its own ``_build/``. Each shape is timed
in turns, other, this, this, other, ``N`` rounds (default 1): device time
per call, 20 calls captured in one CUDA graph and timed with CUDA events.
The two outputs are compared (largest absolute difference; 0 where both
round the same).

The shapes, modes and inputs are ``chip_smoke.py``'s (``conv_case`` at
every packed-conv geometry of the CIFAR-10 and cin256 int4-serving paths,
``conv_geometry_cases``, where the two trees' convs must agree within the
conv's rule; ``int8_matmul_fused`` with bf16 x and out at cin256's
``ff.net.0.proj``, ``attn1.to_out`` and ``ff.net.2`` and the 8x8 level's
``ff.net.2`` (K 384, 1536, 3840), outputs equal; ``timed_linear_shapes``,
``linear_case``, ``FQK_SHAPES``, ``FQK_MODES``, ``fqk_args``;
``flash_pquant`` at the 8- and 16-bit softmax grids at cin256 and SD's
64x64; the int8 GEMM at cin256's ``ff.net.0.proj`` (bf16 out) and on the
im2col of cin256's 64x64 3x3 192 -> 192 conv and of CIFAR-10's largest
conv (int32 out), outputs equal; ``flash_int8`` with and without the 8-bit
softmax quantizer and ``flash_fp`` at cin256 and SD's 64x64, where the two
trees' ``flash_int8`` outputs with the quantizer must agree within the
one-level rule; ``gn_swish_quant_int8`` with SiLU at SD's three resblock
shapes and every ``gn_geometries`` GroupNorm, each tree's codes within
the one-level rule of the plain version's, with torch.profiler rows of
each tree's device work by kernel at SD's shapes), and as controls two
kernels that a slice leaves alone,
``int4_linear`` at cin256's ``ff.net.0.proj`` and the int8 GEMM
(``int8_matmul_pre``) there and at the 8x8 level's ``ff.net.2`` (K 3840,
the wgmma route), outputs equal. ``--kernels`` picks some of int4_conv2d,
int8_matmul_fused, int4_linear, flash_fqk, flash_pquant, int8_gemm,
flash_int8, flash_fp, gn_swish_quant_int8, controls (default: all).
``--sweep`` also times, of those picked, this tree's ``int4_conv2d`` at
every conv geometry under every plan it can take (each block tile, K
whole or split), each checked against the plain version, with the plan
``conv_plan`` picks marked, its ``int8_matmul_fused`` under each route
and panel height (bit-equal to the plain version; ``fused_plan``'s pick
marked), and its ``gn_swish_quant_int8`` at the A/B's shapes under every
plan of ``gn_plans`` (each route, slice width and cluster size, within
the one-level rule; ``gn_plan``'s pick marked). ``--other-unchecked``
times another tree's ``gn_swish_quant_int8`` without holding its codes
to the rule: a build with one part removed (the statistics, the apply,
the cluster exchange) shows what that part costs. Prints the card's name
and power limit, one line per shape and a JSON line with every time.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path

import torch

import chip_smoke as S
from tfmq_dm_tpu_torch.configs.tasks import get_task
from tfmq_dm_tpu_torch.models import ddim_unet
from tfmq_dm_tpu_torch.ops import flash_attention as FA
from tfmq_dm_tpu_torch.ops import gn_kernels as G
from tfmq_dm_tpu_torch.ops import int4_kernels as K
from tfmq_dm_tpu_torch.ops import int8_kernels as I8
from tfmq_dm_tpu_torch.ops.nn import exact_f32
from tfmq_dm_tpu_torch.quant.quantizer import QCfg
from tfmq_dm_tpu_torch.scripts import micro_gn
from tfmq_dm_tpu_torch.utils.timing import device_ms

KERNELS = ("int4_conv2d", "int8_matmul_fused", "int4_linear", "flash_fqk",
           "flash_pquant", "int8_gemm", "flash_int8", "flash_fp",
           "gn_swish_quant_int8", "controls")


def load_other(root: Path, name: str = "tfmq_other_port"):
    """``root``'s ``tfmq_dm_tpu_torch`` as package ``name``; returns its
    int4, flash, int8 and GroupNorm modules."""
    pkg = root / "tfmq_dm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in
                 ("int4_kernels", "flash_attention", "int8_kernels",
                  "gn_kernels"))


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


def conv_cases():
    """Every packed-conv geometry of the two int4-serving paths
    (``chip_smoke.conv_geometry_cases``)."""
    cifar, _ = S.cifar_geometries(ddim_unet.cifar10_config())
    return S.conv_geometry_cases(
        cifar, S.cin_conv_counts(get_task("cin256_v2").unet))


def ab_conv(oK, g, dev, rounds: int, out: list) -> None:
    """``int4_conv2d`` at every conv geometry of both int4-serving paths
    (cin256's 64x64 3x3 192 -> 192, CIFAR-10's 32x32 128 -> 128 and 4x4
    512 -> 256 among them); the two trees' outputs must agree within the
    kernel's rule against its plain version (2e-5 of the largest output,
    in proportion to K beyond 4608)."""
    for path, b, r, k, ci, co, per_fwd in conv_cases():
        case = S.conv_case(g, b, r, k, ci, co, dev)
        res = ab(lambda: oK.int4_conv2d(*case), lambda: K.int4_conv2d(*case),
                 rounds)
        res.update(shape=[b, r, k, ci, co], path=path,
                   launches_per_forward=per_fwd)
        out.append(res)
        report(f"int4_conv2d {path} b{b} {r}x{r} {k}x{k} {ci}->{co}", res)
        S.check_close(f"int4_conv2d {path} {r}x{r} {ci}->{co}, this vs "
                      "other", K.int4_conv2d(*case), oK.int4_conv2d(*case),
                      [], depth=k * k * ci)
        del case
    torch.cuda.empty_cache()


def fused_case(g, m, k, n, dev):
    """``int8_matmul_fused``'s arguments: bf16 x (M, K), deployed int8
    weights, the act grid and a bias."""
    iw = S.int8_weight(g, k, n, False, dev)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(dev)
    a = (x, iw.w_q, iw.delta, iw.zp_c, iw.wsum.float(),
         torch.tensor(0.021, device=dev), torch.tensor(-3.0, device=dev),
         torch.randn(n, generator=g).to(dev))
    return a, iw.w_t


# M, K, N of the fused GEMM's A/B: cin256's ff.net.0.proj, attn1.to_out
# (K 384 -> 384), ff.net.2 (K 1536) and the 8x8 level's ff.net.2 (K 3840)
FUSED_SHAPES = [(4096, 384, 3072), (4096, 384, 384), (4096, 1536, 384),
                (256, 3840, 960)]


def ab_fused(oI8, g, dev, rounds: int, out: list) -> None:
    """``int8_matmul_fused`` (bf16 x and out) at ``FUSED_SHAPES``, with
    the deployed K-major weights in each tree that takes them (a tree
    without ``w_t`` makes its own copy a call); outputs must be equal."""
    takes_wt = "w_t" in inspect.signature(oI8.int8_matmul_fused).parameters
    for m, k, n in FUSED_SHAPES:
        a, w_t = fused_case(g, m, k, n, dev)
        kw = {"w_t": w_t} if takes_wt else {}
        res = ab(lambda: oI8.int8_matmul_fused(*a, out_dtype=torch.bfloat16,
                                               **kw),
                 lambda: I8.int8_matmul_fused(*a, out_dtype=torch.bfloat16,
                                              w_t=w_t), rounds)
        res.update(shape=[m, k, n], what="int8_matmul_fused, bf16")
        out.append(res)
        report(f"int8_matmul_fused M{m} {k}->{n} bf16", res)
        if not res["equal"]:
            raise AssertionError("int8_matmul_fused: the trees' outputs "
                                 "differ")


def ab_controls(oK, oI8, g, dev, rounds: int, out: list) -> None:
    """Two kernels this slice leaves alone, the same call in both trees:
    ``int4_linear`` at cin256's ``ff.net.0.proj`` (M 4096, 384 -> 3072)
    and the int8 GEMM (``int8_matmul_pre``, K-major weights given, bf16
    out) there (mma.sync) and at the 8x8 level's ``ff.net.2`` (M 256,
    3840 -> 960: wgmma, K split); the GEMM's outputs must be equal."""
    m, kk, n = 2 * S.CIN_N * 1024, 384, 3072
    x = S.linear_case(g, m, kk, n, dev)
    r = ab(lambda: oK.int4_linear(*x), lambda: K.int4_linear(*x), rounds)
    r.update(shape=[m, kk, n], what="int4_linear")
    out.append(r)
    report(f"int4_linear M{m} {kk}->{n}", r)
    for m, kk, n in ((m, kk, n), (256, 3840, 960)):
        iw = S.int8_weight(g, kk, n, False, dev)
        xq, zx, dx = S.int8_act(g, (m, kk), dev)
        xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
        a = (xq, xs, iw.w_q, iw.delta, iw.zp_c, iw.wsum.float(), dx, zx,
             torch.randn(n, generator=g).to(dev))
        r = ab(lambda: oI8.int8_matmul_pre(*a, out_dtype=torch.bfloat16,
                                           w_t=iw.w_t),
               lambda: I8.int8_matmul_pre(*a, out_dtype=torch.bfloat16,
                                          w_t=iw.w_t), rounds)
        r.update(shape=[m, kk, n], what="int8_matmul_pre, bf16",
                 plan=list(I8.gemm_plan(m, n, kk)))
        out.append(r)
        report(f"int8_matmul_pre M{m} {kk}->{n} bf16 {r['plan']}", r)
        if not r["equal"]:
            raise AssertionError("int8_matmul_pre: the trees' outputs "
                                 "differ")


# the fused GEMM's sweep: FUSED_SHAPES and K 2304 and 3072, where the
# 64-row panel still fits beside the ring and the streamed panel competes
FUSED_SWEEP_SHAPES = FUSED_SHAPES + [(1024, 2304, 576), (4096, 2304, 384),
                                     (4096, 3072, 384)]


def sweep_fused(g, dev, out: list) -> None:
    """This tree's ``int8_matmul_fused`` (bf16 x and out) at
    ``FUSED_SWEEP_SHAPES`` under each route and panel height it can take
    (groups from ``fused_groups``; device ms each, the outputs equal to
    the plain version's), the plan ``fused_plan`` picks marked."""
    real = I8.fused_plan
    for m, k, n in FUSED_SWEEP_SHAPES:
        a, w_t = fused_case(g, m, k, n, dev)
        ref = I8.int8_matmul_fused_plain(*a, out_dtype=torch.bfloat16)
        picked = real(m, n, k)
        times = {}
        for route in ("panel", "stream"):
            for bm in (128, 64):
                if I8.fused_smem(route, bm, k) > I8.SMEM_PER_SM:
                    continue
                plan = (route, bm, I8.FUSED_BN,
                        I8.fused_groups(route, bm, m, n, k))
                I8.fused_plan = lambda *_a, plan=plan, **_k: plan
                try:
                    def fn():
                        return I8.int8_matmul_fused(
                            *a, out_dtype=torch.bfloat16, w_t=w_t)
                    if not torch.equal(fn(), ref):
                        raise AssertionError(f"int8_matmul_fused M{m} "
                                             f"{k}->{n} {plan}: differs "
                                             "from the plain version")
                    times[plan] = device_ms(fn)
                finally:
                    I8.fused_plan = real
        best = min(times, key=times.get)
        out.append({"shape": [m, k, n], "picked": list(picked),
                    "picked_ms": times[picked], "best": list(best),
                    "best_ms": times[best],
                    "all": [[*p, t] for p, t in times.items()]})
        print(f"sweep int8_matmul_fused M{m} {k}->{n} bf16: picked {picked} "
              f"{times[picked]:.4f} ms, best {best} {times[best]:.4f}; "
              + ", ".join(f"{p}: {t:.4f}" for p, t in sorted(times.items())),
              flush=True)
        del a, w_t, ref
    torch.cuda.empty_cache()


def sweep_conv(g, dev, out: list) -> None:
    """This tree's ``int4_conv2d`` at every conv geometry under every plan
    it can take (``conv_plans`` without the half-card limit; device ms
    each, the outputs within the rule), the plan ``conv_plan`` picks
    marked."""
    real = K.conv_plan
    bad = []
    for path, b, r, k, ci, co, per_fwd in conv_cases():
        case = S.conv_case(g, b, r, k, ci, co, dev)
        ref = K.int4_conv2d_plain(*case)
        m, picked = b * r * r, real(b * r * r, co, k * k, ci)
        times = {}
        for plan in set(K.conv_plans(m, co, k * k, ci, fill=False)) \
                | {picked}:
            K.conv_plan = lambda *_a, plan=plan, **_k: plan
            try:
                S.check_close(f"int4_conv2d {r}x{r} {ci}->{co} {plan}",
                              K.int4_conv2d(*case), ref, [],
                              depth=k * k * ci)
                times[plan] = device_ms(lambda: K.int4_conv2d(*case))
            except AssertionError as e:    # reported, and not timed
                print(f"sweep: {plan} disagrees: {e}", flush=True)
                bad.append([path, [b, r, k, ci, co], list(plan)])
            finally:
                K.conv_plan = real
        if picked not in times:
            continue
        best = min(times, key=times.get)
        out.append({"path": path, "shape": [b, r, k, ci, co],
                    "launches_per_forward": per_fwd,
                    "picked": list(picked), "picked_ms": times[picked],
                    "best": list(best), "best_ms": times[best],
                    "all": [[*p, t] for p, t in times.items()]})
        print(f"sweep int4_conv2d {path} b{b} {r}x{r} {k}x{k} {ci}->{co}: "
              f"picked {picked} {times[picked]:.4f} ms, best {best} "
              f"{times[best]:.4f}; " + ", ".join(
                  f"{p}: {t:.4f}" for p, t in sorted(times.items())),
              flush=True)
        del case, ref
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"int4_conv2d: plans that disagree with the "
                             f"plain version: {bad}")


def profile_rows(fn, calls: int = 20) -> list:
    """Device work of one eager call of ``fn`` by kernel, under
    torch.profiler over ``calls`` calls: [name, launches a call, device
    us a call], longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [[e.key, e.count / calls, e.self_device_time_total / calls]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


def gn_ab_cases(g, dev):
    """``gn_swish_quant_int8``'s A/B and sweep shapes: SD's three resblock
    shapes on the micro_gn twin's inputs (bf16 N(0, 1), the identity
    affine; ``chip_smoke.time_gn``'s), then every GroupNorm of
    ``chip_smoke.gn_geometries`` on ``chip_smoke.gn_case``'s; SiLU on, no
    scale-shift. Yields (label, shape, eps, args)."""
    dz = (torch.tensor(0.02, device=dev), torch.tensor(117.0, device=dev))
    for b, h, w, c, eps, dt in S.gn_shapes(odd=False):
        if (b, h, w, c) in micro_gn.SHAPES:
            x, gamma, beta, d, z = micro_gn.inputs((b, h, w, c), dev)
            args = (x, gamma, beta, d, z)
            label = "SD"
        else:
            x, gamma, beta, _ = S.gn_case(g, b, h, w, c, dt, dev)
            args = (x, gamma, beta, *dz)
            label = "cin256" if dt == torch.bfloat16 else "cifar10"
        yield label, (b, h, w, c), eps, args + (QCfg(bits=8),)


def gn_rule(label: str, got, ref, check: bool = True) -> list:
    """Codes within ``chip_smoke``'s one-level rule of the plain version's
    (unless not ``check``); returns [levels, share]."""
    levels, share = S.gn_levels(got, ref)
    if check and not (levels <= S.GN_MAX_LEVELS
                      and share < S.GN_MAX_SHARE):
        raise AssertionError(f"{label}: {levels} levels, {share:.2e} of "
                             "codes off the plain version")
    return [levels, share]


def gn_plan_of(mod, shape, x) -> list:
    """The plan ``mod`` takes at ``shape`` (none for a tree without
    ``gn_plan``)."""
    b, h, w, c = shape
    plan = getattr(mod, "gn_plan", None)
    return None if plan is None else list(plan(b, h * w, c, 32,
                                               x.element_size()))


def ab_gn(oG, g, dev, rounds: int, out: list,
          check_other: bool = True) -> None:
    """``gn_swish_quant_int8`` (SiLU on, no scale-shift) at
    ``gn_ab_cases``: each tree's codes within the one-level rule of the
    plain version (the other tree's only reported when not
    ``check_other``: a build with a part removed), and at SD's shapes
    each tree's device work by kernel (torch.profiler rows: launches and
    device us a call)."""
    slots = {k: G.cluster_slots(k) for k in G.CLUSTERS}
    print(f"gn_swish_quant_int8: clusters the card runs at once, by size "
          f"(200000 B of shared memory a block): {slots}", flush=True)
    for label, shape, eps, a in gn_ab_cases(g, dev):
        def this():
            return G.gn_swish_quant_int8(*a, eps=eps)[0]

        def other():
            return oG.gn_swish_quant_int8(*a, eps=eps)[0]

        r = ab(other, this, rounds)
        ref = G.gn_swish_quant_int8_plain(*a, eps=eps)[0]
        tag = f"gn_swish_quant_int8 {label} {shape} {str(a[0].dtype)[6:]}"
        r.update(shape=list(shape), dtype=str(a[0].dtype)[6:],
                 plan=gn_plan_of(G, shape, a[0]),
                 this_levels=gn_rule(f"{tag}, this", this(), ref),
                 other_levels=gn_rule(f"{tag}, other", other(), ref,
                                      check_other))
        report(f"{tag} {r['plan']}", r)
        if label == "SD":
            for tree, fn in (("other", other), ("this", this)):
                r[f"profile_{tree}"] = rows = profile_rows(fn)
                print(f"  {tree}: " + "; ".join(
                    f"{name[:60]} x{n:g} {us:.2f} us" for name, n, us in rows),
                    flush=True)
        out.append(r)
        del a, ref
    torch.cuda.empty_cache()


def sweep_gn(g, dev, out: list) -> None:
    """This tree's ``gn_swish_quant_int8`` at ``gn_ab_cases`` under every
    plan it can take (``gn_plans``: each route, slice width, cluster size
    and phase count; device ms each, the codes within the one-level rule),
    the plan ``gn_plan`` picks marked."""
    real = G.gn_plan
    for label, shape, eps, a in gn_ab_cases(g, dev):
        b, h, w, c = shape
        item = a[0].element_size()
        ref = G.gn_swish_quant_int8_plain(*a, eps=eps)[0]
        picked = real(b, h * w, c, 32, item)
        times = {}
        for plan in G.gn_plans(b, h * w, c, 32, item):
            G.gn_plan = lambda *_a, plan=plan, **_k: plan
            try:
                def fn():
                    return G.gn_swish_quant_int8(*a, eps=eps)[0]
                gn_rule(f"gn_swish_quant_int8 {shape} {plan}", fn(), ref)
                times[plan] = device_ms(fn)
            finally:
                G.gn_plan = real
        best = min(times, key=times.get)
        out.append({"shape": list(shape), "dtype": str(a[0].dtype)[6:],
                    "picked": list(picked), "picked_ms": times[picked],
                    "best": list(best), "best_ms": times[best],
                    "all": [[*p, t] for p, t in times.items()]})
        print(f"sweep gn_swish_quant_int8 {label} {shape}: picked {picked} "
              f"{times[picked]:.4f} ms, best {best} {times[best]:.4f} "
              f"({times[picked] / times[best]:.3f}x); " + ", ".join(
                  f"{p}: {t:.4f}" for p, t in sorted(times.items())),
              flush=True)
        del a, ref
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ", ".join(KERNELS))
    ap.add_argument("--sweep", action="store_true",
                    help="also time this tree's int4_conv2d under every "
                         "plan at every conv geometry, int8_matmul_fused "
                         "under every route and gn_swish_quant_int8 under "
                         "every plan (those picked)")
    ap.add_argument("--other-unchecked", action="store_true",
                    help="time the other tree's gn_swish_quant_int8 "
                         "without holding its codes to the rule (a build "
                         "with one part removed)")
    args = ap.parse_args(argv)
    picked = args.kernels.split(",")
    if not set(picked) <= set(KERNELS):
        raise SystemExit(f"ab_kernels: --kernels takes {KERNELS}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs an NVIDIA card")
    exact_f32()
    dev = torch.device("cuda")
    oK, oFA, oI8, oG = load_other(args.other.resolve())
    uses = {"int4": ("int4_conv2d", "int4_linear", "controls"),
            "flash": ("flash_fqk", "flash_pquant", "flash_int8", "flash_fp"),
            "int8": ("int8_matmul_fused", "int8_gemm", "controls"),
            "gn": ("gn_swish_quant_int8",)}
    for key, mods in (("int4", (oK, K)), ("flash", (oFA, FA)),
                      ("int8", (oI8, I8)), ("gn", (oG, G))):
        if set(uses[key]) & set(picked):
            for mod in mods:      # built ahead of the timings
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
    if "int4_conv2d" in picked:
        ab_conv(oK, g, dev, args.rounds, out["int4_conv2d"])
    if "int8_matmul_fused" in picked:
        ab_fused(oI8, g, dev, args.rounds, out["int8_matmul_fused"])
    if "gn_swish_quant_int8" in picked:
        ab_gn(oG, g, dev, args.rounds, out["gn_swish_quant_int8"],
              check_other=not args.other_unchecked)
    if "controls" in picked:
        ab_controls(oK, oI8, g, dev, args.rounds, out["controls"])
    if args.sweep and "int8_matmul_fused" in picked:
        out["sweep_fused"] = []
        sweep_fused(g, dev, out["sweep_fused"])
    if args.sweep and "int4_conv2d" in picked:
        out["sweep"] = []
        sweep_conv(g, dev, out["sweep"])
    if args.sweep and "gn_swish_quant_int8" in picked:
        out["sweep_gn"] = []
        sweep_gn(g, dev, out["sweep_gn"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
