"""Task registry (the port's copy of the tasks it serves from
``tfmq_dm_tpu/configs/tasks.py``): one typed config per model/dataset,
values transcribed from ddim/configs/{cifar10,celeba,church,bedroom}.yml,
models/ldm/{celeba256,ffhq256,lsun_beds256,lsun_churches256}/config.yaml,
configs/latent-diffusion/{cin256-v2,txt2img-1p4B-eval}.yaml,
models/ldm/text2img256/config.yaml and
configs/stable-diffusion/v1-inference.yaml with the reference's sampler
settings (README.md:86-125)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models import bert_text, clip_text, ddim_unet, ldm_unet, vae as vae_mod


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str
    family: str                    # "ddim" | "ldm"
    unet: object
    vae: Optional[vae_mod.VAEConfig] = None
    cond: str = "none"             # "none" | "class" | "text"
    # diffusion schedule
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    num_timesteps: int = 1000
    # default sampler settings
    sampler: str = "ddim"          # ddim|plms (ldm); generalized (ddim)
    steps: int = 100
    eta: float = 0.0
    skip_type: str = "uniform"     # uniform | quad
    cfg_scale: float = 1.0
    # calibration defaults
    cali_n: int = 256              # samples per timestep
    interval_length: int = 1       # weight-phase timestep subsampling
    recon_batch: int = 32
    use_ema: bool = True
    # the text encoder of a cond == "text" task: CLIP (SD v1.x) or, for
    # the LDM text2img family, BERT (BERTEmbedder, modules.py:80-103)
    clip: object = None
    bert: object = None


def cifar10() -> TaskConfig:
    return TaskConfig(
        name="cifar10", family="ddim",
        unet=ddim_unet.cifar10_config(),
        beta_schedule="linear", beta_start=0.0001, beta_end=0.02,
        sampler="generalized", steps=100, eta=0.0, skip_type="quad",
        cali_n=256, interval_length=5)


def _ddim_lsun(name, resolution=256) -> TaskConfig:
    """ddim/configs/{bedroom,church}.yml: 256^2, ch_mult (1,1,2,2,4,4),
    attention at 16x16 (tasks.py:62-71)."""
    unet = ddim_unet.DDIMUNetConfig(
        resolution=resolution, in_channels=3, out_ch=3, ch=128,
        ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
        attn_resolutions=(16,))
    return TaskConfig(
        name=name, family="ddim", unet=unet,
        beta_start=0.0001, beta_end=0.02,
        sampler="generalized", steps=100, eta=0.0, skip_type="uniform")


def ddim_celeba64() -> TaskConfig:
    """ddim/configs/celeba.yml: 64^2, ch_mult (1,2,2,2,4), attention at
    16x16."""
    unet = ddim_unet.DDIMUNetConfig(
        resolution=64, in_channels=3, out_ch=3, ch=128,
        ch_mult=(1, 2, 2, 2, 4), num_res_blocks=2,
        attn_resolutions=(16,))
    return TaskConfig(
        name="ddim_celeba64", family="ddim", unet=unet,
        beta_start=0.0001, beta_end=0.02,
        sampler="generalized", steps=100, eta=0.0, skip_type="uniform",
        cali_n=256, interval_length=5)


def ddim_lsun_bedroom() -> TaskConfig:
    return _ddim_lsun("ddim_lsun_bedroom")


def ddim_lsun_church() -> TaskConfig:
    return _ddim_lsun("ddim_lsun_church")


def tiny_ddim() -> TaskConfig:
    """A CPU-runnable miniature of the ddim family (tasks.py:206-211)."""
    return TaskConfig(
        name="tiny_ddim", family="ddim", unet=ddim_unet.tiny_config(),
        sampler="generalized", steps=5, eta=0.0, skip_type="uniform",
        num_timesteps=100, cali_n=4, interval_length=1, recon_batch=4)


_LDM_VQ4_VAE = vae_mod.VAEConfig(
    ch=128, out_ch=3, in_channels=3, z_channels=3, ch_mult=(1, 2, 4),
    num_res_blocks=2, attn_resolutions=(), resolution=256,
    double_z=False, embed_dim=3, vq=True, n_embed=8192)


def celeba256() -> TaskConfig:
    """LDM-4 CelebA-HQ: unconditional, 200 DDIM steps (tasks.py:106-111)."""
    return TaskConfig(
        name="celeba256", family="ldm", unet=ldm_unet.celeba_config(),
        vae=_LDM_VQ4_VAE, beta_start=0.0015, beta_end=0.0195,
        beta_schedule="linear", sampler="ddim", steps=200, eta=0.0,
        cali_n=256, interval_length=10)


def ffhq256() -> TaskConfig:
    """LDM-4 FFHQ: the CelebA-HQ UNet, stochastic DDIM (eta 1)."""
    return TaskConfig(
        name="ffhq256", family="ldm", unet=ldm_unet.celeba_config(),
        vae=_LDM_VQ4_VAE, beta_start=0.0015, beta_end=0.0195,
        sampler="ddim", steps=200, eta=1.0, cali_n=256,
        interval_length=10)


def lsun_beds256() -> TaskConfig:
    """LDM-4 LSUN-Bedrooms: stochastic DDIM (eta 1)."""
    return TaskConfig(
        name="lsun_beds256", family="ldm",
        unet=ldm_unet.lsun_beds_config(), vae=_LDM_VQ4_VAE,
        beta_start=0.0015, beta_end=0.0195, sampler="ddim", steps=200,
        eta=1.0, cali_n=256, interval_length=10)


def lsun_churches256() -> TaskConfig:
    """LDM-8 LSUN-Churches: KL-f8 latents at ``scale_factor`` 1.0, 400
    DDIM steps (tasks.py:129-141)."""
    kl_f8 = vae_mod.VAEConfig(
        ch=128, out_ch=3, in_channels=3, z_channels=4,
        ch_mult=(1, 2, 4, 4), num_res_blocks=2, attn_resolutions=(),
        resolution=256, double_z=True, embed_dim=4, vq=False,
        scale_factor=1.0)
    return TaskConfig(
        name="lsun_churches256", family="ldm",
        unet=ldm_unet.lsun_churches_config(), vae=kl_f8,
        beta_start=0.0015, beta_end=0.0155, sampler="ddim", steps=400,
        eta=0.0, cali_n=256, interval_length=25)


def cin256_v2() -> TaskConfig:
    return TaskConfig(
        name="cin256_v2", family="ldm", unet=ldm_unet.cin256_config(),
        vae=_LDM_VQ4_VAE, cond="class", beta_start=0.0015,
        beta_end=0.0195, sampler="ddim", steps=20, eta=0.0, cfg_scale=3.0,
        cali_n=512, interval_length=1, recon_batch=8, use_ema=False)


def text2img_256() -> TaskConfig:
    """LDM text2img 256 x 256 (models/ldm/text2img256/config.yaml,
    tasks.py:152-171): VQ-f4 latents (64 x 64), a SpatialTransformer UNet
    with context_dim 640, the BERT encoder 640 x 32; the LDM repo's
    txt2img recipe (50 DDIM steps, CFG 5.0)."""
    unet = ldm_unet.LDMUNetConfig(
        image_size=64, in_channels=3, model_channels=192, out_channels=3,
        attention_resolutions=(8, 4, 2), channel_mult=(1, 2, 3, 5),
        num_head_channels=32, use_spatial_transformer=True,
        transformer_depth=1, context_dim=640)
    return TaskConfig(
        name="text2img_256", family="ldm", unet=unet, vae=_LDM_VQ4_VAE,
        cond="text", beta_start=0.0015, beta_end=0.0195,
        sampler="ddim", steps=50, eta=0.0, cfg_scale=5.0, cali_n=256,
        interval_length=1, recon_batch=8, use_ema=False,
        bert=bert_text.text2img_256_config())


def txt2img_1p4b() -> TaskConfig:
    """LDM-KL-8 text2img 1.4B (configs/latent-diffusion/
    txt2img-1p4B-eval.yaml, tasks.py:174-194): KL-f8 latents (32 x 32,
    256 x 256 images; scale_factor 0.18215), an SD-shaped UNet with
    context_dim 1280, the BERT encoder 1280 x 32."""
    unet = ldm_unet.LDMUNetConfig(
        image_size=32, in_channels=4, model_channels=320, out_channels=4,
        attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
        num_heads=8, use_spatial_transformer=True, transformer_depth=1,
        context_dim=1280, legacy=False)
    kl_f8 = vae_mod.VAEConfig(
        ch=128, out_ch=3, in_channels=3, z_channels=4,
        ch_mult=(1, 2, 4, 4), num_res_blocks=2, attn_resolutions=(),
        resolution=256, double_z=True, embed_dim=4, vq=False,
        scale_factor=0.18215)
    return TaskConfig(
        name="txt2img_1p4b", family="ldm", unet=unet, vae=kl_f8,
        cond="text", beta_schedule="linear", beta_start=0.00085,
        beta_end=0.012, sampler="ddim", steps=50, eta=0.0,
        cfg_scale=5.0, cali_n=256, interval_length=1, recon_batch=8,
        use_ema=False, bert=bert_text.txt2img_1p4b_config())


def sd_v1_4() -> TaskConfig:
    """Stable Diffusion v1.4 (tasks.py:196-203). Sampled at 512 x 512, the
    reference's txt2img.py default (--H 512 --W 512, f 8): 64 x 64
    latents. The yaml's ``image_size: 32``, which the JAX package's
    ``sd_v1_config`` carries and its CLI samples at, is a training crop
    the reference's SD sampler never reads."""
    return TaskConfig(
        name="sd_v1_4", family="ldm",
        unet=dataclasses.replace(ldm_unet.sd_v1_config(), image_size=64),
        vae=vae_mod.sd_vae_config(), cond="text",
        beta_schedule="linear", beta_start=0.00085,
        beta_end=0.012, sampler="plms", steps=50, eta=0.0,
        cfg_scale=7.5, cali_n=256, interval_length=1, recon_batch=8,
        use_ema=False, clip=clip_text.vit_l_14_config())


def tiny_sd() -> TaskConfig:
    """A CPU-runnable text-conditioned miniature of the SD pipeline
    (tasks.py:224-235): tiny CLIP text encoder (stub tokenizer), PLMS with
    CFG, FSC."""
    return TaskConfig(
        name="tiny_sd", family="ldm",
        unet=ldm_unet.tiny_sd_config(context_dim=32),
        vae=vae_mod.tiny_vae_config(), cond="text", beta_start=0.0015,
        beta_end=0.0195, sampler="plms", steps=4, cfg_scale=7.5,
        num_timesteps=100, cali_n=2, interval_length=1, recon_batch=4,
        use_ema=False, clip=clip_text.tiny_clip_config())


def tiny_bert() -> TaskConfig:
    """A CPU-runnable miniature of the BERT-conditioned LDM text2img
    pipeline (tasks.py:235-245): tiny BERT encoder (stub tokenizer), DDIM
    with CFG, FSC."""
    return TaskConfig(
        name="tiny_bert", family="ldm",
        unet=ldm_unet.tiny_sd_config(context_dim=32),
        vae=vae_mod.tiny_vae_config(), cond="text", beta_start=0.0015,
        beta_end=0.0195, sampler="ddim", steps=4, cfg_scale=5.0,
        num_timesteps=100, cali_n=2, interval_length=1, recon_batch=4,
        use_ema=False, bert=bert_text.tiny_bert_config())


def tiny_ldm() -> TaskConfig:
    """A CPU-runnable unconditional miniature of the LDM family
    (tasks.py:214-219)."""
    return TaskConfig(
        name="tiny_ldm", family="ldm", unet=ldm_unet.tiny_ldm_config(),
        vae=vae_mod.tiny_vae_config(), beta_start=0.0015,
        beta_end=0.0195, sampler="ddim", steps=4, num_timesteps=100,
        cali_n=4, interval_length=1, recon_batch=4, use_ema=False)


def tiny_cin() -> TaskConfig:
    return TaskConfig(
        name="tiny_cin", family="ldm",
        unet=ldm_unet.tiny_sd_config(context_dim=16),
        vae=vae_mod.tiny_vae_config(), cond="class", beta_start=0.0015,
        beta_end=0.0195, sampler="ddim", steps=4, cfg_scale=3.0,
        num_timesteps=100, cali_n=4, interval_length=1, recon_batch=4,
        use_ema=False)


TASKS = {"cifar10": cifar10, "tiny_ddim": tiny_ddim, "tiny_ldm": tiny_ldm,
         "tiny_sd": tiny_sd, "tiny_bert": tiny_bert, "tiny_cin": tiny_cin,
         "ddim_celeba64": ddim_celeba64,
         "ddim_lsun_bedroom": ddim_lsun_bedroom,
         "ddim_lsun_church": ddim_lsun_church, "celeba256": celeba256,
         "ffhq256": ffhq256, "lsun_beds256": lsun_beds256,
         "lsun_churches256": lsun_churches256, "cin256_v2": cin256_v2,
         "text2img_256": text2img_256, "txt2img_1p4b": txt2img_1p4b,
         "sd_v1_4": sd_v1_4}


def get_task(name: str) -> TaskConfig:
    return TASKS[name]()


def text_encoder(task: TaskConfig):
    """(module, config) of a text-conditioned task's encoder: ``bert_text``
    where the task names a BERT config, else ``clip_text``. The two
    modules share ``iter_layers``, ``init_params``, ``apply``,
    ``stub_tokenize``, ``empty_prompt_ids`` and ``tokenize``."""
    if task.bert is not None:
        return bert_text, task.bert
    return clip_text, task.clip


def task_betas(task: TaskConfig):
    """The DDPM beta schedule for a task. The two 'linear's differ: the
    ddim family uses a plain linspace (ddim/runners/diffusion.py:51), the
    LDM family a sqrt-spaced one (diffusionmodules/util.py:21-25)."""
    from ..samplers.ldm import make_beta_schedule
    from ..utils.schedules import get_beta_schedule
    if task.family == "ddim":
        return get_beta_schedule(task.beta_schedule,
                                 beta_start=task.beta_start,
                                 beta_end=task.beta_end,
                                 num_diffusion_timesteps=task.num_timesteps)
    return make_beta_schedule(task.beta_schedule, task.num_timesteps,
                              linear_start=task.beta_start,
                              linear_end=task.beta_end)
