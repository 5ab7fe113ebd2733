"""The port's BERT-conditioned LDM text2img slice against the JAX package,
end to end at ``tiny_bert``: a Lightning checkpoint written by the JAX
export (UNet, VQ first stage, the BERT tower under
``cond_stage_model.transformer.``), the CLI's text contexts (stub
tokenizer, and ``--token_ids``), DDIM samples with classifier-free
guidance at the task's 5.0 through the port's CLI (``cli.main``, on the
CPU) in full precision and fake-quant from a JAX-written init-only
artifact (JAX's harvest, minmax grids, the FSC init pass), each against
the JAX CLI's model function (cli.py:385-432) through JAX's
``ddim_scan_ldm`` from the same noise; then ``--ptq --cali`` through the
port's CLI, its harvest fed JAX's contexts, and an int4-serving sample
of the artifact it writes; and the refusals at the published
vocabulary.

Tolerances, those of tests/test_torch_sd_slice.py: the text contexts are
float32 forwards (summation order only: 1e-5 of the largest magnitude);
the full-precision sample is held as tests/test_torch_ddim_slice.py holds
its images (max |diff| within 1.5e-2 of the reference's largest
magnitude, mean |diff| within 1e-2 of its mean magnitude, on the latents
and the decoded images); the fake-quant path at each UNet evaluation,
teacher-forced from JAX's rollout (a row equal to 1e-5, or carrying a
flipped code: at least 30% of the (evaluation, row) pairs equal, mean
|diff| within 1.2% of the mean magnitude, no row beyond 6%), with the UNet
at another FSC group as the negative control. JAX runs in-process.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu import cli as jcli
from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import bert_text as JB
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.pipelines import loading as jload
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.quant import artifact as jart
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.fsc import slice_fsc as j_slice
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import bert_text as TB
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model as t_load

from test_torch_ldm_modules import random_params
from test_torch_sd_slice import (CTX_REL, SAMPLE_MAX_REL, SAMPLE_MEAN_REL,
                                 FORCED_MEAN_REL, _args, _forced,
                                 _forced_ok, _forced_stats, _within)

TASK, N, SEED, SCALE = "tiny_bert", 2, 9, 5.0
PROMPTS = ["a watercolor of a fox in the snow", "a red bicycle"]


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
    """A tiny_bert Lightning checkpoint (JAX export, numpy weights), a
    prompt file and both packages' loaded parameters."""
    tmp = tmp_path_factory.mktemp("bert")
    jtask = jtasks.get_task(TASK)
    rng = np.random.default_rng(SEED)
    parts = (("model.diffusion_model.", JL.iter_layers(jtask.unet)),
             ("first_stage_model.", JV.iter_layers(jtask.vae,
                                                   encoder=False)),
             ("cond_stage_model.transformer.", JB.iter_layers(jtask.bert)))
    sd = {}
    for prefix, layers in parts:
        layers = list(layers)
        p = random_params(layers, rng)
        sd.update({prefix + k: torch.from_numpy(np.array(v))
                   for k, v in j_export(p, layers).items()})
    ckpt = str(tmp / "tiny_bert.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    prompts = tmp / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    jp, jv, jc = jload.load_ldm_checkpoint(ckpt, jtask)
    tp, _, tc = tload.load_ldm_checkpoint(ckpt, ttasks.get_task(TASK),
                                          device="cpu")
    return dict(tmp=tmp, ckpt=ckpt, sd=sd, prompts=str(prompts), jp=jp,
                jv=jv, jc=jc, tp=tp, tc=tc)


def _jax_context(s, n, **kw):
    return jcli._get_context(jtasks.get_task(TASK),
                             _args(**(kw or {"from_file": s["prompts"]})),
                             s["jc"], n)


def _close(got, ref, rel=CTX_REL):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).max() <= rel * np.abs(ref).max()


def test_checkpoint_bert_tower_loads_as_in_jax(setup):
    jc, tc = setup["jc"], setup["tc"]
    assert set(jc) == set(tc) == {
        n for _, n, _ in TB.iter_layers(TB.tiny_bert_config())}
    for name in jc:
        assert set(tc[name]) == set(jc[name]), name
        for f, v in jc[name].items():
            np.testing.assert_array_equal(tc[name][f].numpy(),
                                          np.asarray(v), err_msg=name)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("source", ["prompt", "from_file"])
def test_conditioning_matches_jax(setup, source, n):
    """``cli.conditioning``: the prompts repeated to n rows through the
    stub tokenizer, the empty prompt's as the unconditional row, BERT's
    embeddings (n, 16, 32)."""
    kw = {"prompt": PROMPTS[0]} if source == "prompt" else \
        {"from_file": setup["prompts"]}
    jctx, juc = _jax_context(setup, n, **kw)
    ctx, uc = cli.conditioning(_args(**kw), ttasks.get_task(TASK),
                               setup["tc"], n, "cpu")
    assert tuple(ctx.shape) == (n, 16, 32)
    _close(ctx, jctx)
    _close(uc, juc)


def test_token_ids_give_jaxs_context(setup, tmp_path):
    """``--token_ids``: JAX's encoder on the same ids (its CLI takes no
    ids), rows repeated to n; the file is checked against BERT's shape and
    vocabulary."""
    task = ttasks.get_task(TASK)
    ids = np.random.default_rng(4).integers(0, 100, (2, 16)).astype(np.int32)
    path = tmp_path / "ids.npy"
    np.save(path, ids)
    ctx, uc = cli.conditioning(_args(token_ids=str(path)), task,
                               setup["tc"], 3, "cpu")
    jcfg = jtasks.get_task(TASK).bert
    _close(ctx, JB.apply(setup["jc"], jcfg, jnp.asarray(ids[[0, 1, 0]])))
    _close(uc, JB.apply(setup["jc"], jcfg,
                        JB.stub_tokenize([""] * 3, jcfg)))
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((2, 77), np.int32))
    with pytest.raises(SystemExit, match="shape"):
        cli.conditioning(_args(token_ids=str(bad)), task, setup["tc"], 2,
                         "cpu")
    np.save(bad, np.full((1, 16), 100, np.int32))
    with pytest.raises(SystemExit, match="vocabulary"):
        cli.conditioning(_args(token_ids=str(bad)), task, setup["tc"], 2,
                         "cpu")


def test_published_vocabulary_prompt_and_missing_tower_are_refused(
        setup, tmp_path):
    """At bert-base-uncased's vocabulary prompt text needs its vocabulary
    file, which is not in the repository: the CLI refuses and names it
    (no stub fallback), and asks for ids; ids outside the vocabulary are
    refused; a checkpoint without the BERT tower is refused by name. The
    published tasks parse."""
    for name in ("text2img_256", "txt2img_1p4b"):
        bcfg = ttasks.get_task(name).bert
        with pytest.raises(SystemExit, match="bert-base-uncased"):
            cli.text_token_ids(_args(prompt="a cat"), bcfg, 1)
        with pytest.raises(SystemExit, match="--token_ids"):
            cli.text_token_ids(_args(), bcfg, 1)
        ids = tmp_path / f"{name}.npy"
        np.save(ids, np.full((1, 77), 30522, np.int64))
        with pytest.raises(SystemExit, match="vocabulary"):
            cli.text_token_ids(_args(token_ids=str(ids)), bcfg, 1)
        np.save(ids, np.full((1, 77), 30521, np.int64))
        assert cli.text_token_ids(_args(token_ids=str(ids)), bcfg,
                                  2).tolist() == [[30521] * 77] * 2
        assert cli.build_argparser().parse_args(
            ["--task", name, "--token_ids", str(ids)]).task == name
    no_text = {k: v for k, v in setup["sd"].items()
               if not k.startswith("cond_stage_model.")}
    ckpt = str(tmp_path / "no_text.ckpt")
    torch.save({"state_dict": no_text}, ckpt)
    with pytest.raises(SystemExit, match="BERT text encoder"):
        cli.main(["--task", TASK, "--ckpt", ckpt, "--prompt", "a",
                  "--device", "cpu", "--out", str(tmp_path / "o")])


# ---------------------------------------------------------------------------
# samples: full precision and fake-quant, against JAX
# ---------------------------------------------------------------------------

def _noise(n):
    """The first draw of a generator seeded SEED: the port's CLI starts
    from it, so JAX is handed it too."""
    return torch.randn((n, 8, 8, 3),
                       generator=torch.Generator().manual_seed(SEED)).numpy()


def _jax_sample(s, mode, jw, jast, cali_t, x_T):
    """The JAX CLI's text-conditioned DDIM sampling (cli.py:385-432) in
    ``mode`` (fp / fake), decoded by ``vae.decode``, with every UNet
    evaluation's (x, t, step, output) of the double batch, in order."""
    task = jtasks.get_task(TASK)
    jp = s["jp"]
    ja = JLU.build_adapter(task.unet, w_bits=4, a_bits=8, use_aq=True)
    sampler_fn, sample_t = jptq.make_schedule(task)
    gos = jnp.asarray(jldm.group_of_step_from_t(np.asarray(cali_t),
                                                sample_t), jnp.int32)
    ctx, uc = _jax_context(s, N)

    def qctx(g):
        if mode == "fp":
            return None
        return JCtx(ja.policy, wstate=jw, astate=j_slice(jast, g),
                    use_wq=True, use_aq=True, flash=True)

    evals = []

    def record(*a):
        evals.append(tuple(np.array(v) for v in a))

    kv = JL.build_cross_kv(jp, task.unet, jnp.concatenate([uc, ctx]),
                           qctx=qctx(int(gos[0])))

    def apply_fn(x, t, c, step):
        e = JL.apply(jp, task.unet, x, t, context=c, qctx=qctx(gos[step]),
                     kv_cache=kv)
        jax.debug.callback(record, x, t, step, e, ordered=True)
        return e

    model_fn = jldm.make_cfg_model_fn(apply_fn, ctx, uc, SCALE)
    z = jax.jit(lambda x: sampler_fn(model_fn, x, jax.random.PRNGKey(0)))(
        jnp.asarray(x_T))
    jax.effects_barrier()
    img = jnp.clip((JV.decode(s["jv"], task.vae, z) + 1.0) / 2.0, 0.0, 1.0)
    return np.asarray(z), np.asarray(img), evals


@pytest.fixture(scope="module")
def slice_runs(setup):
    s = setup
    tmp = s["tmp"]
    jtask = jtasks.get_task(TASK)
    x_T = _noise(N)
    # JAX: the init-only artifact from a harvest of the port's starting
    # noise (DDIM with CFG), minmax grids and the FSC init pass
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
    ja = JLU.build_adapter(jtask.unet, w_bits=4, a_bits=8, use_aq=True)
    jw = j_iwq(ja.policy, s["jp"], scaler="minmax")
    jast = j_fsc(ja, s["jp"], jw, ja_cali, jax.random.PRNGKey(1),
                 running_stat=False, init_samples=2 * N,
                 act_scaler="minmax")
    art = str(tmp / "cali.npz")
    jart.save_artifact(art, jw, jast, {
        "task": TASK, "wq": 4, "aq": 8, "softmax_a_bit": 8, "use_aq": True,
        "cali_t": [float(v) for v in cali_t]})

    common = ["--task", TASK, "--ckpt", s["ckpt"], "--from-file",
              s["prompts"], "-n", str(N), "--batch", str(N), "--seed",
              str(SEED), "--device", "cpu"]
    flags = {"fp": [], "fake": ["--ptq", "--cali_ckpt", art, "--use_aq"]}
    real_cfg = cli.make_cfg_model_fn
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

        with mock.patch.object(cli, "make_cfg_model_fn", spy_cfg):
            rc = cli.main(common + extra + ["--out", out])
        jz, jimg, evals = _jax_sample(s, mode, jw, jast, cali_t, x_T)
        runs[mode] = dict(rc=rc, jz=jz, jimg=jimg, evals=evals,
                          cli_fns=spied,
                          tz=np.load(os.path.join(out, "latents.npy")),
                          timg=np.load(os.path.join(out, "samples.npy")))
    return dict(runs=runs, cali_t=np.asarray(cali_t))


def test_cli_fp_ddim_sample_matches_jax(slice_runs):
    """Full precision, DDIM with CFG from the same noise: latents and
    decoded images (the VQ decode's argmin sees latents 1e-6 apart)."""
    r = slice_runs["runs"]["fp"]
    assert r["rc"] == 0
    assert r["tz"].shape == r["jz"].shape == (N, 8, 8, 3)
    assert r["timg"].shape == r["jimg"].shape == (N, 16, 16, 3)
    assert np.all(np.isfinite(r["timg"]))
    assert r["timg"].min() >= 0 and r["timg"].max() <= 1
    _within(r["tz"], r["jz"], SAMPLE_MAX_REL, SAMPLE_MEAN_REL)
    _within(r["timg"], r["jimg"], SAMPLE_MAX_REL, SAMPLE_MEAN_REL)


@pytest.mark.parametrize("mode", ["fp", "fake"])
def test_cli_model_fn_teacher_forced_matches_jax(slice_runs, mode):
    """Each of JAX's DDIM evaluations, one a step, fed at the same (x, t,
    step) to the port CLI's model function: the FSC group, the cached
    cross-attention K/V of BERT's context, the fake-quant UNet and the
    guidance combine at 5.0."""
    r = slice_runs["runs"][mode]
    fns = r["cli_fns"]
    t_seq = jptq.make_schedule(jtasks.get_task(TASK))[1]
    order = [(int(t_seq[i]), i) for i in range(len(t_seq))]
    assert [(int(t[0]), int(st)) for _, t, st, _ in r["evals"]] == order
    assert fns["calls"] == order
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


def test_teacher_forced_limits_fail_another_group(slice_runs):
    """Negative control: every fake-quant evaluation at the next step's
    FSC group (one group a step) fails the limits, and the first at
    step 1's group moves the mean beyond them."""
    r = slice_runs["runs"]["fake"]
    n = len(r["evals"])
    np.testing.assert_array_equal(
        slice_runs["cali_t"], jptq.make_schedule(jtasks.get_task(TASK))[1])
    first = _forced_stats([_forced(r, 0, step=1)])
    assert first[0] > FORCED_MEAN_REL and first[1] == 0.0, first
    shifted = _forced_stats([_forced(r, k, step=(int(r["evals"][k][2]) + 1)
                                     % n) for k in range(n)])
    assert not _forced_ok(shifted), shifted


# ---------------------------------------------------------------------------
# --ptq --cali, and its artifact sampled with the int4-serving deployment
# ---------------------------------------------------------------------------

CALI_STEPS, CALI_N, ITERS = 2, 2, 4


@pytest.fixture(scope="module")
def cali_run(setup):
    s = setup
    art = str(s["tmp"] / "port_cali.npz")
    calls = []
    real = tptq.generate_cali_data

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    with mock.patch.object(tptq, "generate_cali_data", spy):
        rc = cli.main(["--task", TASK, "--ckpt", s["ckpt"], "--ptq",
                       "--cali", "--use_aq", "--from-file", s["prompts"],
                       "--timesteps", str(CALI_STEPS), "--cali_n",
                       str(CALI_N), "--cali_iters", str(ITERS),
                       "--cali_save_path", art, "--seed", str(SEED),
                       "--device", "cpu"])
    out = s["tmp"] / "int4"
    rc_sample = cli.main(["--task", TASK, "--ckpt", s["ckpt"], "--ptq",
                          "--cali_ckpt", art, "--use_aq", "--int-kernels",
                          "--int4-serving", "--from-file", s["prompts"],
                          "-n", "3", "--batch", "3", "--device", "cpu",
                          "--out", str(out)])
    return dict(rc=rc, art=art, calls=calls, rc_sample=rc_sample, out=out)


def test_cli_cali_harvests_with_jaxs_contexts(setup, cali_run):
    """The harvest gets the JAX CLI's contexts of the prompts and the
    empty prompt (cli.py:288), CALI_N rows each, and the task's scale."""
    assert cali_run["rc"] == 0
    (kw,) = cali_run["calls"]
    assert kw["n_per_t"] == CALI_N and kw["cfg_scale"] is None
    jctx, juc = _jax_context(setup, CALI_N)
    _close(kw["context"], jctx)
    _close(kw["uncond"], juc)


def test_cli_cali_artifact_samples_int4_serving(cali_run):
    """The artifact: every trained unit reconstructed, FSC over the
    harvest's groups; ``cli.main --int-kernels --int4-serving`` samples
    it on the CPU (the kernels' plain versions)."""
    _, astate, meta = t_load(cali_run["art"], device="cpu")
    assert meta["task"] == TASK and len(meta["cali_t"]) == CALI_STEPS
    assert len(meta["recon"]["units"]) == 22
    assert meta["fsc"]["groups"] == CALI_STEPS and astate
    assert cali_run["rc_sample"] == 0
    img = np.load(cali_run["out"] / "samples.npy")
    lat = np.load(cali_run["out"] / "latents.npy")
    assert img.shape == (3, 16, 16, 3) and lat.shape == (3, 8, 8, 3)
    assert np.all(np.isfinite(img)) and np.all(np.isfinite(lat))
    assert img.min() >= 0 and img.max() <= 1
