"""The port's Stable Diffusion v1.4 modules against the JAX package, on the
CPU: the CLIP text encoder and its stub tokenizer, the SD UNet's layer
walk, quantization policy and reconstruction units at full width (no
parameters built), the PLMS sampler and the KL-f8 first-stage decode.

Tolerances: the text encoder and the decoder are float32 forwards that
differ from JAX's only in summation order (1e-5 relative to the output's
largest magnitude); PLMS on a linear model function runs the same f32
step arithmetic (1e-6). Layer walks, policies, units and token ids are
compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import clip_text as JC
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import clip_text as TC
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU
from tfmq_dm_tpu_torch.models import vae as TV
from tfmq_dm_tpu_torch.samplers import ldm as tldm

from test_torch_ldm_modules import random_params

REL = 1e-5


def close(got, ref, rel=REL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

def test_clip_config_and_layers_match_jax():
    for name in ("vit_l_14_config", "tiny_clip_config"):
        jc, tc = getattr(JC, name)(), getattr(TC, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert list(TC.iter_layers(tc)) == list(JC.iter_layers(jc))
    p = TC.init_params(torch.Generator().manual_seed(0),
                       TC.vit_l_14_config(), device="meta")
    assert sum(v.numel() for f in p.values() for v in f.values()) == \
        123_060_480


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_apply_matches_jax(seed):
    """last_hidden_state at tiny_clip_config on random ids of the full
    length (the causal mask matters at every position)."""
    cfg = JC.tiny_clip_config()
    rng = np.random.default_rng(seed)
    np_p = random_params(JC.iter_layers(cfg), rng)
    ids = rng.integers(0, cfg.vocab_size, (3, cfg.max_len)).astype(np.int32)
    ref = JC.apply(jax.tree.map(jnp.asarray, np_p), cfg, jnp.asarray(ids))
    got = TC.apply(params_from_numpy(np_p, "cpu"), TC.tiny_clip_config(),
                   torch.from_numpy(ids))
    close(got.numpy(), ref)


def test_clip_init_params_follow_the_jax_scheme():
    cfg = TC.tiny_clip_config()
    p = TC.init_params(torch.Generator().manual_seed(0), cfg)
    assert set(p) == {n for _, n, _ in TC.iter_layers(cfg)}
    fc = p["text_model.encoder.layers.0.mlp.fc1"]
    assert fc["w"].shape == (32, 128)
    assert fc["w"].abs().max() <= 32 ** -0.5 and not fc["b"].any()
    assert torch.equal(p["text_model.final_layer_norm"]["scale"],
                       torch.ones(32))


TEXTS = ["a photograph of an astronaut riding a horse", "", "Hello  World",
         " ".join(f"w{i}" for i in range(100))]


@pytest.mark.parametrize("cfg_name", ["tiny_clip_config", "vit_l_14_config"])
def test_stub_tokenize_ids_equal_jax(cfg_name):
    jc, tc = getattr(JC, cfg_name)(), getattr(TC, cfg_name)()
    got = TC.stub_tokenize(TEXTS, tc)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JC.stub_tokenize(TEXTS, jc)))


def test_empty_prompt_ids():
    """CLIP's "" (start, then end-of-text as padding) at CLIP's
    vocabulary; the stub tokenizer's "" elsewhere."""
    full = TC.empty_prompt_ids(2, TC.vit_l_14_config())
    assert full.shape == (2, 77)
    assert full[:, 0].tolist() == [49406, 49406]
    assert (full[:, 1:] == 49407).all()
    tiny = TC.tiny_clip_config()
    assert torch.equal(TC.empty_prompt_ids(3, tiny),
                       TC.stub_tokenize(["", "", ""], tiny))


def test_bpe_tokenize_refuses_and_names_the_missing_files():
    with pytest.raises(RuntimeError, match="vocab.json"):
        TC.tokenize(["a cat"])


# ---------------------------------------------------------------------------
# SD UNet at full width: layer walk, policy, units (no parameters built)
# ---------------------------------------------------------------------------

def test_sd_unet_config_and_heads():
    jc, tc = JL.sd_v1_config(), TL.sd_v1_config()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    heads = {(s.heads, s.d_head) for s in TL._all_subs(tc)
             if s.kind == "strans"}
    assert heads == {(8, 40), (8, 80), (8, 160)}
    # the task samples 512 x 512 (64 x 64 latents); the model is the same
    task = ttasks.get_task("sd_v1_4")
    assert dataclasses.replace(task.unet, image_size=32) == tc
    assert task.unet.image_size == 64


def test_sd_tasks_match_jax():
    for name in ("sd_v1_4", "tiny_sd"):
        j, t = jtasks.get_task(name), ttasks.get_task(name)
        for f in ("family", "cond", "beta_schedule", "beta_start",
                  "beta_end", "num_timesteps", "sampler", "steps", "eta",
                  "cfg_scale", "cali_n", "interval_length", "recon_batch",
                  "use_ema"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert dataclasses.asdict(t.vae) == dataclasses.asdict(j.vae)
        # the JAX task leaves ViT-L/14 implied (clip None); the port names it
        assert dataclasses.asdict(t.clip) == dataclasses.asdict(
            j.clip or JC.vit_l_14_config())
    assert dataclasses.asdict(ttasks.get_task("tiny_sd").unet) == \
        dataclasses.asdict(jtasks.get_task("tiny_sd").unet)


def test_sd_layer_walk_matches_jax():
    cfg = TL.sd_v1_config()
    walk = list(TL.iter_layers(cfg))
    assert walk == list(JL.iter_layers(JL.sd_v1_config()))
    kinds = {}
    for kind, _, shape in walk:
        key = (kind, shape[0]) if kind == "conv" else kind
        kinds[key] = kinds.get(key, 0) + 1
    assert kinds[("conv", 3)] == 49 and kinds[("conv", 1)] == 32
    assert kinds["linear"] + kinds["linear_nb"] == 184
    assert kinds["linear_nb"] == 96
    assert kinds["conv_fp"] == 14 and kinds["conv_ds"] == 3
    n = sum(int(np.prod(s)) for k, _, s in walk if k not in ("norm", "lnorm"))
    assert 859.0e6 < n < 859.1e6


def _policy_spec(policy):
    def cfg(q):
        return None if q is None else dataclasses.astuple(q)
    return [(n, p.wq, p.aq, p.recon, p.quant_emb, cfg(p.w_cfg),
             cfg(p.a_cfg)) for n, p in ((n, policy.get(n))
                                        for n in policy.order)]


@pytest.mark.parametrize("use_aq", [False, True])
def test_sd_layer_infos_policy_and_units_match_jax(use_aq):
    jc, tc = JL.sd_v1_config(), TL.sd_v1_config()
    ti = TL.layer_infos(tc, use_aq=use_aq)
    ji = JL.layer_infos(jc, use_aq=use_aq)
    assert len(ti) == 393
    assert [dataclasses.astuple(i) for i in ti] == \
        [(i.name, i.kind, i.quant_emb, i.softmax, i.unit) for i in ji]
    ta = TLU.build_adapter(tc, w_bits=4, a_bits=8, use_aq=use_aq)
    ja = JLU.build_adapter(jc, w_bits=4, a_bits=8, use_aq=use_aq)
    assert _policy_spec(ta.policy) == _policy_spec(ja.policy)

    def spec(adapter):
        return [(u.name, u.kind, u.layers, u.act_sites, u.extra, u.recon,
                 sorted(adapter.default_train_roles(u)))
                for u in adapter.units]
    assert spec(ta) == spec(ja)
    assert len(ta.units) == 75
    assert sum(bool(u.recon and ta.default_train_roles(u))
               for u in ta.units) == 74


# ---------------------------------------------------------------------------
# PLMS
# ---------------------------------------------------------------------------

def _linear_model(rng, shape, steps):
    """eps = a * x + b * t / 1000 + c[step]: linear in x, and a
    per-step term that shows which step each evaluation carries."""
    a = np.float32(rng.uniform(0.2, 0.6))
    b = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal((steps,) + shape).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 5])
def test_plms_matches_jax(steps):
    """x_0, the trajectory (collect="traj": each step's main input) and
    the (t, step) of every model evaluation, n + 1 of them, the second at
    step 0 carrying step min(1, n - 1) and the next step's t."""
    rng = np.random.default_rng(steps)
    shape = (2, 4, 4, 3)
    a, b, c = _linear_model(rng, shape[1:], steps)
    betas = jldm.make_beta_schedule("linear", 1000, 0.00085, 0.012)
    ac = np.cumprod(1.0 - betas)
    # make_ddim_timesteps' uniform spacing at steps that divide 1000
    ts = np.arange(steps) * (1000 // steps) + 1
    jsched = jldm.DDIMScheduleLDM(ac, ts)
    tsched = tldm.DDIMScheduleLDM(ac, ts)
    x = rng.standard_normal(shape).astype(np.float32)

    jcalls = []

    def jmodel(xt, t, step):
        jax.debug.callback(lambda tt, ss: jcalls.append((int(tt[0]),
                                                         int(ss))),
                           t, step, ordered=True)
        return a * xt + jnp.asarray(b) * (t[:, None, None, None] / 1000.0) \
            + jnp.asarray(c)[step]

    jx, (jxs, jts) = jax.jit(lambda x0: jldm.plms_scan(
        jmodel, jsched, x0, collect="traj"))(jnp.asarray(x))
    jax.effects_barrier()

    tcalls = []

    def tmodel(xt, t, step):
        tcalls.append((int(t[0]), int(step)))
        return a * xt + torch.from_numpy(b) * (t[:, None, None, None]
                                               / 1000.0) \
            + torch.from_numpy(c)[step]

    tx, (txs, tts) = tldm.plms_scan(tmodel, tsched, torch.from_numpy(x),
                                    collect="traj")
    assert len(tcalls) == steps + 1
    assert tcalls == jcalls
    assert tcalls[1] == (int(tsched.t[min(1, steps - 1)]), min(1, steps - 1))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    assert torch.equal(tldm.plms_scan(tmodel, tsched, torch.from_numpy(x)),
                       tx)


# ---------------------------------------------------------------------------
# KL-f8 first stage
# ---------------------------------------------------------------------------

def test_sd_vae_config_matches_jax():
    assert dataclasses.asdict(TV.sd_vae_config()) == \
        dataclasses.asdict(JV.sd_vae_config())
    walk = list(TV.iter_layers(TV.sd_vae_config()))
    assert walk == list(JV.iter_layers(JV.sd_vae_config(), encoder=False))
    n = sum(int(np.prod(s)) for k, _, s in walk if k != "norm")
    assert 49.4e6 < n < 49.6e6


def test_kl_decode_matches_jax():
    kw = dict(vq=False, double_z=True, z_channels=4, embed_dim=4,
              scale_factor=0.18215)
    jc, tc = JV.tiny_vae_config(**kw), TV.tiny_vae_config(**kw)
    rng = np.random.default_rng(5)
    np_p = random_params(JV.iter_layers(jc, encoder=False), rng)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = JV.decode(jax.tree.map(jnp.asarray, np_p), jc, jnp.asarray(z))
    got = TV.decode(params_from_numpy(np_p, "cpu"), tc, torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    close(got.numpy(), ref)
