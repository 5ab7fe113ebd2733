"""The port's text-conditioned (Stable Diffusion) slice against the JAX
package, end to end at ``tiny_sd``: a Lightning checkpoint written by the
JAX export (UNet, first stage, CLIP text tower under
``cond_stage_model.transformer.``), the CLI's text contexts (stub
tokenizer, and ``--token_ids``), the PLMS calibration harvest with
classifier-free guidance at the task's 7.5, a JAX-written calibration
artifact, and PLMS samples through the port's CLI (``cli.main``, on the
CPU) in full precision, fake-quant and the int8 deployment, each against
the JAX CLI's model function (cli.py:385-432) through JAX's ``plms_scan``
from the same noise. tests/test_torch_sd_cali_cli.py holds ``--cali``
against the JAX CLI's artifact on the same checkpoint.

The int8 deployment packs the 4-bit weights of its weight-only sites
(the time and ResBlock embedding linears) for the int4 GEMM. The port's
plain version rounds as the TPU kernel does (bf16 operands and dequant);
JAX's CPU dispatch would keep f32, which moves every row of a UNet
output by about 2%. So the JAX int8 reference takes JAX's TPU route for
those linears, with ``int4_matmul_dequant``'s arithmetic written in jnp
(its interpreted Pallas kernel costs some 30 s a forward here;
tests/test_torch_int4_kernels.py holds the port's plain version against
it).

Tolerances. Integer state is compared exactly (weight grids, deployed
codes, hard-rounded AdaRound codes). The text contexts and the harvest
are float32 forwards (summation order only: 1e-5). The full-precision
sample is held as test_torch_ddim_slice.py holds its images: max |diff|
within 1.5e-2 of the reference's largest magnitude, mean |diff| within
1e-2 of its mean magnitude, on the latents and the decoded images
(measured 1.6e-6 on data seeds 7-9).

The quantized paths are held at each UNet evaluation (teacher-forced):
JAX's rollout records the (x, t, step) and the output of every
evaluation, and the port CLI's model function is fed the same (x, t,
step). An activation one f32 ulp from a rounding boundary flips a code
on one side, and in this small UNet a flip moves the whole batch row:
rows are either equal to summation order (1e-5 of the largest
magnitude) or carry a flip (up to 2.9% on seeds 7-9). Limits: at least
30% of the (evaluation, row) pairs equal (measured 60-85%), mean |diff|
within 1.2% of the mean magnitude over the evaluations (measured
0.28-0.62%), no row beyond 6%. The UNet at another FSC group fails
them: no row equal, mean |diff| 2.4-4.6% at every evaluation (the
negative-control test). The sampled latents are held loosely: a flip
changes eps by a few percent after guidance at 7.5, and a PLMS step
scales an eps difference by a small factor, so their limits (latents
within 10% max / 7% mean; measured 2.7-4.0% / 1.2-2.8% on seeds 7-9)
tell a full-precision sample from a quantized one (the FP sample is
12-14% / 10-11% from JAX's quantized ones: a negative-control test) but
not one evaluation at a wrong group. The VQ decode's argmin turns latent
differences into whole patches, so there the decoded images are held
against JAX's decode of the port's own latents (1e-5).
"""

import argparse
import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu import cli as jcli
from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import clip_text as JC
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.ops import pallas_kernels as jpk
from tfmq_dm_tpu.pipelines import loading as jload
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.quant import artifact as jart
from tfmq_dm_tpu.quant import deploy as jdep
from tfmq_dm_tpu.quant import qfunc as jqfunc
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.fsc import slice_fsc as j_slice
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import clip_text as TC
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq

from test_torch_deploy_slice import _assert_int_state_equal
from test_torch_ldm_modules import random_params

N, SEED, SCALE = 2, 7, 7.5
PROMPTS = ["a photograph of an astronaut riding a horse",
           "an oil painting of a lighthouse"]
CTX_REL = 1e-5
SAMPLE_MAX_REL, SAMPLE_MEAN_REL = 1.5e-2, 1e-2   # full precision
QUANT_LATENT_MAX_REL, QUANT_LATENT_MEAN_REL = 0.1, 0.07
# teacher-forced UNet outputs of the quantized paths
FORCED_EXACT_REL = 1e-5      # a row equal to summation order
FORCED_EXACT_SHARE = 0.3     # of the (evaluation, row) pairs
FORCED_MEAN_REL = 0.012      # mean |diff| / mean |ref|
FORCED_ROW_MAX_REL = 0.06    # a row's max |diff| / max |ref|


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread (see
    test_torch_ldm_cali_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny_sd Lightning checkpoint (JAX export, numpy weights) and a
    prompt file; both packages' loaded parameters."""
    tmp = tmp_path_factory.mktemp("sd")
    jtask = jtasks.get_task("tiny_sd")
    rng = np.random.default_rng(SEED)
    parts = (("model.diffusion_model.", JL.iter_layers(jtask.unet)),
             ("first_stage_model.", JV.iter_layers(jtask.vae,
                                                   encoder=False)),
             ("cond_stage_model.transformer.",
              JC.iter_layers(jtask.clip)))
    sd = {}
    for prefix, layers in parts:
        layers = list(layers)
        p = random_params(layers, rng)
        sd.update({prefix + k: torch.from_numpy(np.array(v))
                   for k, v in j_export(p, layers).items()})
    ckpt = str(tmp / "tiny_sd.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    prompts = tmp / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n\n")
    jp, jv, jc = jload.load_ldm_checkpoint(ckpt, jtask)
    tp, _, tc = tload.load_ldm_checkpoint(ckpt, ttasks.get_task("tiny_sd"),
                                          device="cpu")
    return dict(tmp=tmp, ckpt=ckpt, prompts=str(prompts), jp=jp, jv=jv,
                jc=jc, tp=tp, tc=tc)


def _args(**kw):
    a = dict(prompt=None, from_file=None, token_ids=None)
    a.update(kw)
    return argparse.Namespace(**a)


def _jax_context(s, n):
    return jcli._get_context(jtasks.get_task("tiny_sd"),
                             _args(from_file=s["prompts"]), s["jc"], n)


def test_checkpoint_text_encoder_loads_as_in_jax(setup):
    jc, tc = setup["jc"], setup["tc"]
    assert set(jc) == set(tc) == {
        n for _, n, _ in TC.iter_layers(TC.tiny_clip_config())}
    for name in jc:
        for f, v in jc[name].items():
            np.testing.assert_array_equal(tc[name][f].numpy(),
                                          np.asarray(v), err_msg=name)


@pytest.mark.parametrize("n", [2, 3])
def test_text_context_matches_jax(setup, n):
    """The prompts repeated to n rows, the stub tokenizer, the empty
    prompt as the unconditional row."""
    jctx, juc = _jax_context(setup, n)
    ctx, uc = cli.text_context(_args(from_file=setup["prompts"]),
                               ttasks.get_task("tiny_sd"), setup["tc"], n,
                               "cpu")
    assert tuple(ctx.shape) == (n, 16, 32) and tuple(uc.shape) == (n, 16, 32)
    for got, ref in ((ctx, jctx), (uc, juc)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= \
            CTX_REL * np.abs(ref).max()


def test_token_ids_give_the_prompts_context(setup, tmp_path):
    """--token_ids of the stub tokenizer's ids of the prompts gives the
    context --from-file gives; rows repeat to n as prompts do."""
    task = ttasks.get_task("tiny_sd")
    ids = tmp_path / "ids.npy"
    np.save(ids, TC.stub_tokenize(PROMPTS, task.clip).numpy().astype(
        np.int32))
    for n in (2, 3):
        got = cli.text_context(_args(token_ids=str(ids)), task, setup["tc"],
                               n, "cpu")
        ref = cli.text_context(_args(from_file=setup["prompts"]), task,
                               setup["tc"], n, "cpu")
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((2, 77), np.int32))
    with pytest.raises(SystemExit, match="shape"):
        cli.text_context(_args(token_ids=str(bad)), task, setup["tc"], 2,
                         "cpu")
    np.save(bad, np.full((1, 16), 100, np.int32))
    with pytest.raises(SystemExit, match="vocabulary"):
        cli.text_context(_args(token_ids=str(bad)), task, setup["tc"], 2,
                         "cpu")
    with pytest.raises(SystemExit, match="not both"):
        cli.text_context(_args(token_ids=str(ids), prompt="a"), task,
                         setup["tc"], 2, "cpu")


def test_full_vocabulary_prompt_is_refused(setup, tmp_path):
    """At CLIP's vocabulary prompt text needs the BPE files, which are not
    in the repository: the CLI refuses and names them (it does not fall
    back to the stub tokenizer); so does a text task with no prompt, and
    a checkpoint without the text encoder."""
    sd = ttasks.get_task("sd_v1_4")
    with pytest.raises(SystemExit, match="merges.txt"):
        cli.text_token_ids(_args(prompt="a cat"), sd.clip, 1)
    with pytest.raises(SystemExit, match="--token_ids"):
        cli.text_token_ids(_args(), TC.vit_l_14_config(), 1)
    full = dict(torch.load(setup["ckpt"])["state_dict"])
    no_text = {k: v for k, v in full.items()
               if not k.startswith("cond_stage_model.")}
    ckpt = str(tmp_path / "no_text.ckpt")
    torch.save({"state_dict": no_text}, ckpt)
    with pytest.raises(SystemExit, match="cond_stage_model.transformer"):
        cli.main(["--task", "tiny_sd", "--ckpt", ckpt, "--prompt", "a",
                  "--device", "cpu", "--out", str(tmp_path / "o")])


# ---------------------------------------------------------------------------
# harvest, artifact, samples
# ---------------------------------------------------------------------------

def _noise(n):
    """The first draw of a generator seeded SEED: the port's harvest and
    its CLI each start from it, so JAX is handed it for both."""
    return torch.randn((n, 8, 8, 3),
                       generator=torch.Generator().manual_seed(SEED)).numpy()


def _int4_matmul_jnp(x, w_packed, delta_w, zp_wc, bias=None, block_n=256,
                     out_dtype=jnp.float32, **_):
    """``pallas_kernels.int4_matmul_dequant``'s arithmetic in jnp: the
    nibble tiles unpacked as ``dequant_packed_conv_weights`` does, the
    dequant in bf16 arithmetic, bf16 operands, f32 accumulation."""
    n = w_packed.shape[1] * 2
    bn = min(block_n, n)
    wq = jnp.concatenate([jpk._unpack_int4(w_packed[:, j:j + bn // 2])
                          for j in range(0, n // 2, bn // 2)], axis=1)
    w = (wq.astype(jnp.bfloat16) - zp_wc.astype(jnp.bfloat16)) \
        * delta_w.astype(jnp.bfloat16)
    out = jnp.dot(x.astype(jnp.bfloat16), w,
                  preferred_element_type=jnp.float32)
    return (out if bias is None else out + bias).astype(out_dtype)


class _TPUBackend:
    """``jax`` as ``quant/qfunc.py`` sees it on a TPU: its packed 4-bit
    linears take the kernel route (qfunc.py:114-124)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def _jax_sample(s, mode, jw, jast, cali_t, x_T):
    """The JAX CLI's text-conditioned PLMS sampling (cli.py:385-432) in
    ``mode`` (fp / fake / int8), decoded by ``vae.decode``; with every
    UNet evaluation's (x, t, step, output) of the double batch, in order.
    The int8 deployment's packed 4-bit linears (the weight-only sites)
    take JAX's TPU route, the kernel's bf16 arithmetic written in jnp, as
    the port's int4 plain versions round; its CPU dispatch would keep
    f32 (qfunc.py:125)."""
    task = jtasks.get_task("tiny_sd")
    jp = s["jp"]
    ja = JLU.build_adapter(task.unet, w_bits=4, a_bits=8, use_aq=True)
    sampler_fn, sample_t = jptq.make_schedule(task)
    gos = jnp.asarray(jldm.group_of_step_from_t(np.asarray(cali_t),
                                                sample_t), jnp.int32)
    ctx, uc = _jax_context(s, N)
    jd = None
    if mode == "int8":
        jd = jdep.deploy_weights(ja.policy, jp, jw, int4_serving=False)
        jd = jdep.specialize_maps(ja, jp, jd, example_args=(
            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32), ctx[:1]))
        assert any(isinstance(w, jdep.Int4Weight) for w in jd.values())

    def qctx(g):
        if mode == "fp":
            return None
        if mode == "int8":
            return JCtx(ja.policy, wstate={}, astate=j_slice(jast, g),
                        use_wq=True, use_aq=True, deploy=jd, flash=True)
        return JCtx(ja.policy, wstate=jw, astate=j_slice(jast, g),
                    use_wq=True, use_aq=True, flash=True)

    evals = []

    def record(*a):
        evals.append(tuple(np.array(v) for v in a))

    def apply_fn(x, t, c, step):
        e = JL.apply(jp, task.unet, x, t, context=c, qctx=qctx(gos[step]),
                     kv_cache=kv)
        jax.debug.callback(record, x, t, step, e, ordered=True)
        return e

    route = (mock.patch.object(jqfunc, "jax", _TPUBackend()),
             mock.patch.object(jpk, "int4_matmul_dequant", _int4_matmul_jnp)
             ) if mode == "int8" else ()
    with contextlib.ExitStack() as stack:
        for patch in route:
            stack.enter_context(patch)
        kv = JL.build_cross_kv(jp, task.unet, jnp.concatenate([uc, ctx]),
                               qctx=qctx(int(gos[0])))
        model_fn = jldm.make_cfg_model_fn(apply_fn, ctx, uc, SCALE)
        z = jax.jit(lambda x: sampler_fn(model_fn, x,
                                         jax.random.PRNGKey(0)))(
            jnp.asarray(x_T))
    img = jnp.clip((JV.decode(s["jv"], task.vae, z) + 1.0) / 2.0, 0.0, 1.0)
    return np.asarray(z), np.asarray(img), jd, evals


@pytest.fixture(scope="module")
def slice_runs(setup):
    s = setup
    tmp = s["tmp"]
    jtask, ttask = jtasks.get_task("tiny_sd"), ttasks.get_task("tiny_sd")
    rng = np.random.default_rng(SEED + 1)
    x_T = _noise(N)
    # JAX: harvest (PLMS with CFG) from the port's starting noise
    jctx, juc = _jax_context(s, N)
    real_normal = jax.random.normal

    def cali_noise(key, shape, dtype=None):
        return jnp.asarray(x_T) if dtype is None else \
            real_normal(key, shape, dtype)

    jax.random.normal = cali_noise
    try:
        _, ja_cali, cali_t = jptq.generate_cali_data(
            jtask, lambda x, t, c: JL.apply(s["jp"], jtask.unet, x, t,
                                            context=c),
            jax.random.PRNGKey(0), n_per_t=N, context=jctx, uncond=juc,
            cfg_scale=SCALE)
    finally:
        jax.random.normal = real_normal
    # grids with AdaRound alphas as reconstruction leaves them, FSC init
    ja = JLU.build_adapter(jtask.unet, w_bits=4, a_bits=8, use_aq=True)
    jw = j_iwq(ja.policy, s["jp"], scaler="minmax")
    for n in jw:
        jw[n]["alpha"] = jnp.asarray(rng.standard_normal(
            s["jp"][n]["w"].shape).astype(np.float32))
    jast = j_fsc(ja, s["jp"], jw, ja_cali, jax.random.PRNGKey(1),
                 running_stat=False, init_samples=2 * N,
                 act_scaler="minmax")
    art = str(tmp / "cali.npz")
    jart.save_artifact(art, jw, jast, {
        "task": "tiny_sd", "wq": 4, "aq": 8, "softmax_a_bit": 8,
        "use_aq": True, "cali_t": [float(v) for v in cali_t]})

    # port: its own harvest of the same model, and the CLI's samples
    tctx, tuc = cli.text_context(_args(from_file=s["prompts"]), ttask,
                                 s["tc"], N, "cpu")
    _, ta_cali, tcali_t = tptq.generate_cali_data(
        ttask, lambda x, t, c: TL.apply(s["tp"], ttask.unet, x, t,
                                        context=c),
        torch.Generator().manual_seed(SEED), n_per_t=N, context=tctx,
        uncond=tuc, device="cpu")
    common = ["--task", "tiny_sd", "--ckpt", s["ckpt"], "--from-file",
              s["prompts"], "-n", str(N), "--batch", str(N), "--seed",
              str(SEED), "--device", "cpu"]
    quant = ["--ptq", "--cali_ckpt", art, "--use_aq"]
    flags = {"fp": [], "fake": quant, "int8": quant + ["--int-kernels"]}
    real_cfg, real_deploy = cli.make_cfg_model_fn, cli.deploy
    runs = {}
    for mode, extra in flags.items():
        out = str(tmp / mode)
        spied = {}

        def spy_cfg(apply_fn, ctx, uc, scale):
            spied.update(apply_fn=apply_fn, c_in=torch.cat([uc, ctx]),
                         scale=scale, calls=[])
            spied["model_fn"] = real_cfg(apply_fn, ctx, uc, scale)

            def model_fn(x, t, step):
                spied["calls"].append((int(t[0]), step))
                return spied["model_fn"](x, t, step)
            return model_fn

        def spy_deploy(*a, **kw):
            spied["deploy"] = real_deploy(*a, **kw)
            return spied["deploy"]

        with mock.patch.object(cli, "make_cfg_model_fn", spy_cfg), \
                mock.patch.object(cli, "deploy", spy_deploy):
            rc = cli.main(common + extra + ["--out", out])
        jz, jimg, jd, evals = _jax_sample(s, mode, jw, jast, cali_t, x_T)
        tz = np.load(os.path.join(out, "latents.npy"))
        runs[mode] = dict(rc=rc, jz=jz, jimg=jimg, jd=jd, tz=tz,
                          evals=evals, cli_fns=spied,
                          timg=np.load(os.path.join(out, "samples.npy")),
                          jimg_of_tz=np.asarray(jnp.clip((JV.decode(
                              s["jv"], jtask.vae, jnp.asarray(tz)) + 1.0)
                              / 2.0, 0.0, 1.0)))
    return dict(runs=runs, ja_cali=ja_cali, ta_cali=ta_cali, cali_t=cali_t,
                tcali_t=tcali_t, td=runs["int8"]["cli_fns"]["deploy"][0])


def test_plms_harvest_matches_jax(slice_runs):
    """FP PLMS rollouts with CFG: each step's main input, groups doubled
    [uncond; cond] with the text contexts."""
    np.testing.assert_array_equal(slice_runs["tcali_t"],
                                  slice_runs["cali_t"])
    for t, j in zip(slice_runs["ta_cali"], slice_runs["ja_cali"]):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5)
    assert slice_runs["ta_cali"][0].shape[:2] == (4, 2 * N)
    assert slice_runs["ta_cali"][2].shape[2:] == (16, 32)


def test_int8_deployed_state_bit_equal(slice_runs):
    """The port's deployment of the JAX artifact: codes, weight sums,
    scales and border maps equal to JAX's."""
    _assert_int_state_equal(slice_runs["runs"]["int8"]["jd"],
                            slice_runs["td"])


def _is_within(got, ref, max_rel, mean_rel):
    d = np.abs(got - ref)
    return bool(d.max() <= max_rel * np.abs(ref).max()
                and d.mean() <= mean_rel * np.abs(ref).mean())


def _within(got, ref, max_rel, mean_rel):
    d = np.abs(got - ref)
    assert d.max() <= max_rel * np.abs(ref).max()
    assert d.mean() <= mean_rel * np.abs(ref).mean()


@pytest.mark.parametrize("mode", ["fp", "fake", "int8"])
def test_cli_plms_sample_matches_jax(slice_runs, mode):
    """The port's CLI against JAX from the same noise (see the module
    docstring for the limits)."""
    r = slice_runs["runs"][mode]
    assert r["rc"] == 0
    assert r["tz"].shape == r["jz"].shape == (N, 8, 8, 3)
    assert r["timg"].shape == r["jimg"].shape == (N, 16, 16, 3)
    assert np.all(np.isfinite(r["timg"]))
    assert r["timg"].min() >= 0 and r["timg"].max() <= 1
    if mode == "fp":
        _within(r["tz"], r["jz"], SAMPLE_MAX_REL, SAMPLE_MEAN_REL)
        _within(r["timg"], r["jimg"], SAMPLE_MAX_REL, SAMPLE_MEAN_REL)
    else:
        _within(r["tz"], r["jz"], QUANT_LATENT_MAX_REL,
                QUANT_LATENT_MEAN_REL)
    _within(r["timg"], r["jimg_of_tz"], CTX_REL, CTX_REL)


def test_fp_sample_fails_the_quantized_limits(slice_runs):
    """Negative control of the latent limits: the port's full-precision
    sample is not within QUANT_LATENT_* of JAX's fake-quant or int8
    sample (measured 12-14% max / 10-11% mean on seeds 7-9)."""
    fp = slice_runs["runs"]["fp"]["tz"]
    for mode in ("fake", "int8"):
        assert not _is_within(fp, slice_runs["runs"][mode]["jz"],
                              QUANT_LATENT_MAX_REL, QUANT_LATENT_MEAN_REL)


def _forced(r, k, step=None):
    """(port, JAX) UNet outputs of the double batch at the JAX rollout's
    k-th evaluation, the port's through the CLI's model function (its
    apply, before the guidance combine) at the same (x, t), with the
    evaluation's step index or ``step``."""
    x, t, st, ref = r["evals"][k]
    fns = r["cli_fns"]
    with torch.no_grad():
        got = fns["apply_fn"](torch.from_numpy(x), torch.from_numpy(t),
                              fns["c_in"], int(st) if step is None
                              else step)
    return got.numpy(), ref


def _forced_stats(pairs):
    """(mean |diff| / mean |ref| over the evaluations, share of the
    (evaluation, row) pairs equal to summation order, largest row
    |diff| / max |ref|)."""
    means, exact, worst = [], [], 0.0
    for got, ref in pairs:
        d, sc = np.abs(got - ref), np.abs(ref).max()
        means.append(d.mean() / np.abs(ref).mean())
        rows = d.reshape(d.shape[0], -1).max(axis=1) / sc
        exact.extend(rows <= FORCED_EXACT_REL)
        worst = max(worst, float(rows.max()))
    return float(np.mean(means)), float(np.mean(exact)), worst


def _forced_ok(stats):
    mean, exact, worst = stats
    return mean <= FORCED_MEAN_REL and exact >= FORCED_EXACT_SHARE and \
        worst <= FORCED_ROW_MAX_REL


@pytest.mark.parametrize("mode", ["fp", "fake", "int8"])
def test_cli_model_fn_teacher_forced_matches_jax(slice_runs, mode):
    """Each of the n + 1 UNet evaluations of JAX's PLMS rollout (step 0's
    Euler correction at (x_prev, t_next) carries step 1), fed at the same
    (x, t, step) to the port CLI's model function: the FSC group, the
    cached cross-attention K/V, the deployed or fake-quant UNet and the
    guidance combine (see the module docstring for the limits)."""
    r = slice_runs["runs"][mode]
    fns = r["cli_fns"]
    t_seq = jptq.make_schedule(jtasks.get_task("tiny_sd"))[1]
    order = [(int(t_seq[0]), 0), (int(t_seq[1]), 1)] + \
        [(int(t_seq[i]), i) for i in range(1, len(t_seq))]
    assert [(int(t[0]), int(st)) for _, t, st, _ in r["evals"]] == order
    assert fns["calls"] == order          # the CLI's own rollout
    assert fns["scale"] == SCALE
    pairs = [_forced(r, k) for k in range(len(r["evals"]))]
    for k, (got, _) in enumerate(pairs):
        x, t, st, _ = r["evals"][k]
        with torch.no_grad():
            e = fns["model_fn"](torch.from_numpy(x[:N]),
                                torch.from_numpy(t[:N]), int(st)).numpy()
        np.testing.assert_array_equal(
            e, got[:N] + np.float32(SCALE) * (got[N:] - got[:N]))
    stats = _forced_stats(pairs)
    if mode == "fp":
        assert stats[2] <= CTX_REL, stats
    else:
        assert _forced_ok(stats), stats


@pytest.mark.parametrize("mode", ["fake", "int8"])
def test_teacher_forced_limits_fail_another_group(slice_runs, mode):
    """Negative control of the teacher-forced limits: the Euler
    evaluation at step 0's group (group 0, where it must take group 1),
    and every evaluation at the next step's group, fail them."""
    r = slice_runs["runs"][mode]
    n = len(r["evals"]) - 1
    # one FSC group a step: another step's index is another group
    np.testing.assert_array_equal(
        slice_runs["cali_t"], jptq.make_schedule(jtasks.get_task(
            "tiny_sd"))[1])
    assert r["evals"][1][2] == 1
    euler = _forced_stats([_forced(r, 1, step=0)])
    assert euler[0] > FORCED_MEAN_REL and euler[1] == 0.0, euler
    shifted = _forced_stats([_forced(r, k, step=(int(r["evals"][k][2]) + 1)
                                     % n) for k in range(n + 1)])
    assert not _forced_ok(shifted), shifted
