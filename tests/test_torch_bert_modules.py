"""The port's BERT text family against the JAX package, on the CPU: the
BERT text encoder (configs, layer walk, init scheme, forward, stub
tokenizer, the empty prompt's ids, the refusing WordPiece tokenizer), the
three tasks (``text2img_256``, ``txt2img_1p4b``, ``tiny_bert``), the
tiny_bert UNet's layer infos, quantization policy and reconstruction
units, and the two published UNets' layer walks at full width (shapes
only: no parameter is built).

Tolerances: the encoder is a float32 forward that differs from JAX's only
in summation order (1e-5 relative to the output's largest magnitude).
Layer walks, policies, units, task fields and token ids are compared
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import bert_text as JB
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import bert_text as TB
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU

from test_torch_ldm_modules import random_params
from test_torch_sd_modules import TEXTS, _policy_spec, close

CONFIGS = ("txt2img_1p4b_config", "text2img_256_config", "tiny_bert_config")
TASKS = ("text2img_256", "txt2img_1p4b", "tiny_bert")


# ---------------------------------------------------------------------------
# the BERT text encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_bert_config_and_layers_match_jax(name):
    """Names, kinds, shapes and their order (x-transformers' state_dict
    paths)."""
    jc, tc = getattr(JB, name)(), getattr(TB, name)()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert list(TB.iter_layers(tc)) == list(JB.iter_layers(jc))


@pytest.mark.parametrize("name, lo, hi", [
    ("txt2img_1p4b_config", 542.5e6, 543.5e6),
    ("text2img_256_config", 166.5e6, 166.7e6)])
def test_bert_full_width_parameter_count(name, lo, hi):
    """1280 x 32 and 640 x 32 with the fixed 512-wide attention, on the
    meta device (nothing allocated)."""
    p = TB.init_params(torch.Generator().manual_seed(0),
                       getattr(TB, name)(), device="meta")
    n = sum(v.numel() for f in p.values() for v in f.values())
    assert lo < n < hi, n


# a width that is not heads x dim_head (the reference's 8 x 64 = 512
# against 1280 or 640), at a miniature's size
ODD_CFG = dict(vocab_size=50, dim=24, depth=2, heads=2, dim_head=16,
               max_len=10)


@pytest.mark.parametrize("cfg_kw", [None, ODD_CFG],
                         ids=["tiny_bert", "dim_ne_inner"])
def test_bert_apply_matches_jax(cfg_kw):
    """Embeddings on random ids of the full length, non-causal and
    unmasked: every position attends to every other."""
    jc = JB.tiny_bert_config() if cfg_kw is None else \
        JB.BERTTextConfig(**cfg_kw)
    tc = TB.tiny_bert_config() if cfg_kw is None else \
        TB.BERTTextConfig(**cfg_kw)
    rng = np.random.default_rng(3)
    np_p = random_params(JB.iter_layers(jc), rng)
    ids = rng.integers(0, jc.vocab_size, (3, jc.max_len)).astype(np.int32)
    ref = JB.apply(jax.tree.map(jnp.asarray, np_p), jc, jnp.asarray(ids))
    got = TB.apply(params_from_numpy(np_p, "cpu"), tc, torch.from_numpy(ids))
    assert tuple(got.shape) == (3, jc.max_len, jc.dim)
    close(got.numpy(), ref)


def test_bert_init_params_follow_the_jax_scheme():
    cfg = TB.tiny_bert_config()
    p = TB.init_params(torch.Generator().manual_seed(0), cfg)
    assert set(p) == {n for _, n, _ in TB.iter_layers(cfg)}
    q = p["attn_layers.layers.0.1.to_q"]
    assert set(q) == {"w"} and q["w"].shape == (32, 16)
    assert q["w"].abs().max() <= 32 ** -0.5
    ff = p["attn_layers.layers.1.1.net.2"]
    assert ff["w"].shape == (128, 32) and not ff["b"].any()
    assert ff["w"].abs().max() <= 128 ** -0.5
    emb = p["token_emb"]["w"]
    assert emb.shape == (100, 32) and 0.01 < float(emb.std()) < 0.03
    assert torch.equal(p["norm"]["scale"], torch.ones(32))
    assert not p["norm"]["bias"].any()
    # a generator seeds the draw
    again = TB.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["token_emb"]["w"], emb)


@pytest.mark.parametrize("cfg_name", ["tiny_bert_config",
                                      "txt2img_1p4b_config"])
def test_bert_stub_tokenize_ids_equal_jax(cfg_name):
    jc, tc = getattr(JB, cfg_name)(), getattr(TB, cfg_name)()
    got = TB.stub_tokenize(TEXTS, tc)
    assert got.dtype == torch.int64 and tuple(got.shape) == (4, tc.max_len)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JB.stub_tokenize(TEXTS, jc)))


def test_bert_empty_prompt_ids():
    """bert-base-uncased's "" padded to max_length ([CLS], [SEP], then
    [PAD]) at its vocabulary; the stub tokenizer's "" elsewhere."""
    full = TB.empty_prompt_ids(2, TB.text2img_256_config())
    assert full.shape == (2, 77) and full.dtype == torch.int64
    assert full[:, :2].tolist() == [[101, 102], [101, 102]]
    assert not full[:, 2:].any()
    tiny = TB.tiny_bert_config()
    assert torch.equal(TB.empty_prompt_ids(3, tiny),
                       TB.stub_tokenize(["", "", ""], tiny))


def test_bert_empty_prompt_ids_equal_the_wordpiece_tokenizer(tmp_path):
    """The reference's tokenizer call (modules.py:57-66, truncation and
    padding to max_length) on a vocabulary file of bert-base-uncased's
    size with its special tokens at their indices: the ids the JAX CLI
    would hand its encoder for the empty prompt (bert_text.py:168-176)."""
    transformers = pytest.importorskip("transformers")
    words = [f"[unused{i}]" for i in range(30522)]
    for i, tok in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"),
                   (102, "[SEP]"), (103, "[MASK]")):
        words[i] = tok
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab),
                                         do_lower_case=True)
    enc = tok(["", ""], truncation=True, max_length=77,
              padding="max_length", return_tensors="np")
    np.testing.assert_array_equal(
        TB.empty_prompt_ids(2, TB.txt2img_1p4b_config()).numpy(),
        enc["input_ids"])


def test_bert_tokenize_refuses_and_names_the_missing_vocabulary():
    with pytest.raises(RuntimeError, match="bert-base-uncased"):
        TB.tokenize(["a cat"])


# ---------------------------------------------------------------------------
# the tasks and their UNets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TASKS)
def test_bert_tasks_match_jax(name):
    j, t = jtasks.get_task(name), ttasks.get_task(name)
    for f in ("family", "cond", "beta_schedule", "beta_start", "beta_end",
              "num_timesteps", "sampler", "steps", "eta", "skip_type",
              "cfg_scale", "cali_n", "interval_length", "recon_batch",
              "use_ema"):
        assert getattr(t, f) == getattr(j, f), (name, f)
    assert dataclasses.asdict(t.unet) == dataclasses.asdict(j.unet)
    assert dataclasses.asdict(t.vae) == dataclasses.asdict(j.vae)
    assert dataclasses.asdict(t.bert) == dataclasses.asdict(j.bert)
    assert t.clip is None
    enc, ecfg = ttasks.text_encoder(t)
    assert enc is TB and ecfg is t.bert


@pytest.mark.parametrize("use_aq", [False, True])
def test_tiny_bert_layer_infos_policy_and_units_match_jax(use_aq):
    jc, tc = (m.get_task("tiny_bert").unet for m in (jtasks, ttasks))
    ti = TL.layer_infos(tc, use_aq=use_aq)
    ji = JL.layer_infos(jc, use_aq=use_aq)
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
    assert sum(bool(u.recon and ta.default_train_roles(u))
               for u in ta.units) == 22


@pytest.mark.parametrize("name, lo, hi, heads", [
    ("txt2img_1p4b", 871e6, 873e6, {(8, 40), (8, 80), (8, 160)}),
    ("text2img_256", 403.2e6, 403.4e6, {(12, 32), (18, 32), (30, 32)})])
def test_published_unet_layer_walk_matches_jax(name, lo, hi, heads):
    """The full-width UNets' layer walks by shapes (no parameter built):
    equal to JAX's, with the heads of their spatial transformers."""
    jc, tc = (m.get_task(name).unet for m in (jtasks, ttasks))
    walk = list(TL.iter_layers(tc))
    assert walk == list(JL.iter_layers(jc))
    n = sum(int(np.prod(s)) for k, _, s in walk if k not in ("norm",
                                                              "lnorm"))
    assert lo < n < hi, n
    assert {(s.heads, s.d_head) for s in TL._all_subs(tc)
            if s.kind == "strans"} == heads
