"""Latent diffusion application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/latent_diffusion/model.py: LDMConfig,
LDMModule (a UNet, a KL VAE and PAI-Diffusion's BERT text tower under
CompVis's names), LatentDiffusion and StableDiffusionPipeline.

- Training: VAE-encode (a posterior sample) -> random timestep -> q_sample
  -> the UNet's noise prediction -> l2 (or l1) against the noise. All the
  randomness of a step (t, the noise, the posterior's normals) is drawn by
  `draw_training_noise` from an explicit torch.Generator, and the loss
  takes the draws as arguments (`diffusion_loss`), so a test can feed it
  the JAX package's draws. Dropout, where the text tower's config has it,
  draws from torch's own stream.
- Sampling: DDIM, PLMS or DPM-Solver++ with classifier-free guidance (two
  UNet calls a step, conditioned and unconditioned, as JAX's
  `_make_denoise`), then the VAE decode, clipped to [-1, 1]. Without a
  negative prompt the unconditioned branch reads an all-PAD prompt, as
  JAX's `sample` does; the pipeline tokenizes "" instead, as JAX's does.
- The JAX app's other samplers: the ControlNet sampler, FreePromptEditing
  (`edit`, self-attention maps shared across the source and target
  halves), cross-frame video stylization (`stylize_video`, img2img) and
  the learned OLSS scheduler (`fit_olss`, `make_olss_sampler`).

Pixels enter as [B, H, W, 3] in [-1, 1] (the dataset's rows, as JAX's) and
images leave as [B, H, W, 3]; the modules run NCHW. Latents are
[B, latent_channels, h, w].
"""

import os

import numpy as np
import torch
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
from easynlp_tpu_torch.modelzoo.models.latent_diffusion import conversion
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.autoencoder import (
    AutoencoderKL,
    init_module_weights,
)
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.ddim import (
    DiffusionSchedule,
    ddim_img2img,
    ddim_sample,
    dpm_solver_pp_sample,
    draw_normal,
    plms_sample,
    sample_steps,
)
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.unet import UNetModel
from easynlp_tpu_torch.utils.logger import logger

SAMPLERS = {"ddim": ddim_sample, "plms": plms_sample,
            "dpm++": dpm_solver_pp_sample}
ESRGAN_FLAX_NAME = "flax_params_esrgan.msgpack"


class LDMConfig(PretrainedConfig):
    model_type = "latent_diffusion"

    def __init__(self, image_size=256, latent_channels=4, model_channels=128,
                 channel_mult=(1, 2, 4), num_res_blocks=2,
                 attention_levels=(1, 2), num_heads=8, context_dim=768,
                 vae_channels=64, vae_channel_mult=(1, 2, 4),
                 vae_num_res_blocks=1, num_train_timesteps=1000,
                 scale_factor=0.18215, text_config=None, loss_type="l2",
                 **kwargs):
        self.image_size = image_size
        self.latent_channels = latent_channels
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.attention_levels = tuple(attention_levels)
        self.num_heads = num_heads
        self.context_dim = context_dim
        self.in_channels = latent_channels
        self.out_channels = latent_channels
        self.vae_channels = vae_channels
        self.vae_channel_mult = tuple(vae_channel_mult)
        self.vae_num_res_blocks = vae_num_res_blocks
        self.num_train_timesteps = num_train_timesteps
        self.scale_factor = scale_factor
        self.loss_type = loss_type
        self.text_config_dict = text_config or {}
        super().__init__(**kwargs)

    @property
    def text_config(self):
        return BertConfig(**self.text_config_dict)

    @property
    def latent_size(self):
        return self.image_size // 2 ** (len(self.vae_channel_mult) - 1)


class _DiffusionWrapper(nn.Module):
    """CompVis's `model` (DiffusionWrapper): the UNet as `diffusion_model`."""

    def __init__(self, unet):
        super().__init__()
        self.diffusion_model = unet


class _TextTower(nn.Module):
    """PAI-Diffusion's `cond_stage_model`: the BERT as `transformer`."""

    def __init__(self, config, dtype, device):
        super().__init__()
        self.transformer = BertModel(config, dtype=dtype,
                                     add_pooling_layer=False, device=device)


class LDMModule(nn.Module):
    """All three towers, with the JAX LDMModule's methods."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.model = _DiffusionWrapper(UNetModel(config, dtype, device))
        self.first_stage_model = AutoencoderKL(config, dtype, device)
        self.cond_stage_model = _TextTower(config.text_config, dtype, device)

    @property
    def unet(self):
        return self.model.diffusion_model

    @torch.no_grad()
    def init_weights(self, generator):
        init_module_weights(self.model, generator)
        init_module_weights(self.first_stage_model, generator)
        self.cond_stage_model.transformer.init_weights(generator)

    def encode_text(self, input_ids, attention_mask=None):
        return self.cond_stage_model.transformer(
            input_ids, attention_mask=attention_mask)["last_hidden_state"]

    def encode_image(self, pixels, posterior_noise=None):
        """pixels [B, 3, H, W] -> scaled latents; with posterior_noise
        (standard normals of the latents' shape) a posterior sample, else
        its mean."""
        mean, logvar = self.first_stage_model.moments(pixels)
        if posterior_noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * posterior_noise
        return mean * self.config.scale_factor

    def decode_latents(self, latents):
        return self.first_stage_model.decode(latents
                                             / self.config.scale_factor)

    def predict_noise(self, noisy_latents, timesteps, context,
                      share_self=None, cross_frame=False, control=None):
        return self.unet(noisy_latents, timesteps, context=context,
                         share_self=share_self, cross_frame=cross_frame,
                         control=control)


def nchw(pixels):
    """[B, H, W, 3] -> [B, 3, H, W] f32."""
    return pixels.permute(0, 3, 1, 2).float()


def _device_tensor(x, device, dtype=None):
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype) if dtype else x.to(device)


class LatentDiffusion(Application):
    model_input_keys = ("pixel_values", "input_ids", "attention_mask")

    def __init__(self, module, config, device, label_mapping=None):
        super().__init__(module, config, device, label_mapping)
        self.schedule = DiffusionSchedule(config.num_train_timesteps)

    # -- loading --------------------------------------------------------------
    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return LDMConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return LDMModule(config, dtype=dtype, device=device)

    @classmethod
    def convert_pytorch_state_dict(cls, state_dict, config):
        """A CompVis/PAI-Diffusion state dict under the port's names."""
        return conversion.normalize_keys(state_dict)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        state = cls.convert_pytorch_state_dict(state_dict, module.config)
        if any(k.startswith(conversion.TEXT_PREFIX) for k in state):
            module.load_state_dict(state, strict=True)
            return
        # no text tower in the checkpoint: it keeps its init, as the JAX
        # conversion leaves it
        missing, unexpected = module.load_state_dict(state, strict=False)
        missing = [k for k in missing
                   if not k.startswith(conversion.TEXT_PREFIX)]
        if missing or unexpected:
            raise RuntimeError("checkpoint does not fit the LDMModule: "
                               "missing %s, unexpected %s"
                               % (missing[:5], unexpected[:5]))
        logger.info("no text tower in the checkpoint: cond_stage_model "
                    "keeps its init")

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return conversion.state_dict_from_jax(params, config)

    def export_state_dict(self):
        return self.module.state_dict()

    def latent_shape(self, batch):
        c = self.config
        return (batch, c.latent_channels, c.latent_size, c.latent_size)

    # -- training -------------------------------------------------------------
    def draw_training_noise(self, batch_size, generator, latent_hw=None):
        """A training step's draws from `generator`: timesteps t [B], the
        noise and the posterior's standard normals, both of the latents'
        shape, on the app's device."""
        c = self.config
        hw = latent_hw or c.latent_size
        shape = (batch_size, c.latent_channels, hw, hw)
        t = torch.randint(0, c.num_train_timesteps, (batch_size,),
                          generator=generator, device=generator.device)
        return {"t": t.to(self.device),
                "noise": draw_normal(shape, generator, self.device),
                "posterior": draw_normal(shape, generator, self.device)}

    def diffusion_loss(self, batch, draws, control=None, per_sample=False):
        """The eps-prediction loss of a batch ({"input_ids",
        "attention_mask", "pixel_values" [B, H, W, 3]}) at the given draws
        (draw_training_noise's; "posterior" may be None for the posterior
        mean). control(noisy, t, context) gives ControlNet residuals.
        per_sample: [B] means, else the scalar mean."""
        module, c = self.module, self.config
        context = module.encode_text(batch["input_ids"],
                                     batch.get("attention_mask"))
        latents = module.encode_image(nchw(batch["pixel_values"]),
                                      draws.get("posterior"))
        t, noise = draws["t"], draws["noise"]
        noisy = self.schedule.q_sample(latents, t, noise)
        residuals = control(noisy, t, context) if control else None
        pred = module.predict_noise(noisy, t, context, control=residuals)
        err = (pred - noise).abs() if c.loss_type == "l1" \
            else (pred - noise) ** 2
        if per_sample:
            return err.reshape(err.shape[0], -1).mean(-1)
        return err.mean()

    def draw_step_noise(self, batch, generator):
        """A training step's draws for `batch`, this rank's rows of the
        global batch: the draws of every data-parallel rank's rows are
        made from the step's generator in one go and each rank takes its
        block, so a step on a data mesh draws what one process draws."""
        from easynlp_tpu_torch.parallel.mesh import (batch_sharding,
                                                     data_parallel_size)
        hw = batch["pixel_values"].shape[1] // 2 ** (
            len(self.config.vae_channel_mult) - 1)
        n = batch["input_ids"].shape[0] * data_parallel_size()
        draws = self.draw_training_noise(n, generator, hw)
        start, stop = batch_sharding(n)
        return {k: v[start:stop] for k, v in draws.items()}

    def make_train_loss(self):
        """The Trainer's loss: loss_fn(batch, generator) -> {"loss": ...}
        (the counterpart of the JAX app's make_train_loss)."""
        def loss_fn(batch, generator):
            return {"loss": self.diffusion_loss(
                batch, self.draw_step_noise(batch, generator))}
        return loss_fn

    @staticmethod
    def loss_fn(outputs, batch):
        raise NotImplementedError(
            "latent diffusion trains through make_train_loss (its timesteps "
            "and noise are drawn per step)")

    # -- sampling -------------------------------------------------------------
    def _ids(self, input_ids, attention_mask=None, negative_input_ids=None):
        ids = _device_tensor(input_ids, self.device, torch.int64)
        mask = _device_tensor(attention_mask, self.device, torch.int64)
        if negative_input_ids is None:
            neg = torch.full_like(ids, self.config.text_config.pad_token_id)
        else:
            neg = _device_tensor(negative_input_ids, self.device,
                                 torch.int64)
        return ids, mask, neg

    def make_denoise(self, input_ids, attention_mask, negative_input_ids,
                     guidance_scale, share_self=None, cross_frame=False,
                     control=None):
        """The classifier-free-guided noise predictor every sampler calls:
        eps_u + s (eps_c - eps_u) from a conditioned and an unconditioned
        UNet call (one call at guidance_scale <= 1). share_self(t) gives
        the map-sharing flag of a step; control(x, t, context) the
        ControlNet residuals."""
        module = self.module
        context = module.encode_text(input_ids, attention_mask)
        uncond = (module.encode_text(negative_input_ids, None)
                  if guidance_scale > 1.0 else None)

        def eps(x, t, ctx):
            return module.predict_noise(
                x, t, ctx, share_self=share_self(t) if share_self else None,
                cross_frame=cross_frame,
                control=control(x, t, ctx) if control else None)

        def denoise(x, t):
            eps_c = eps(x, t, context)
            if uncond is None:
                return eps_c
            eps_u = eps(x, t, uncond)
            return eps_u + guidance_scale * (eps_c - eps_u)

        return denoise

    def decode(self, latents):
        """latents -> images [B, H, W, 3] in [-1, 1], f32."""
        with torch.inference_mode():
            images = self.module.decode_latents(latents)
        return images.clamp(-1.0, 1.0).permute(0, 2, 3, 1)

    def make_sampler(self, num_steps=50, guidance_scale=7.5, method="ddim",
                     decode=True):
        """sampler(input_ids, attention_mask, negative_input_ids, generator,
        x_init=None) -> images [B, H, W, 3] (decode=False: the final
        latents; decode() then gives the images). method: 'ddim', 'plms'
        or 'dpm++'."""
        sample_fn = SAMPLERS[method]

        def sampler(input_ids, attention_mask, negative_input_ids,
                    generator=None, x_init=None):
            ids, mask, neg = self._ids(input_ids, attention_mask,
                                       negative_input_ids)
            with torch.inference_mode():
                denoise = self.make_denoise(ids, mask, neg, guidance_scale)
                latents = sample_fn(denoise, self.latent_shape(ids.shape[0]),
                                    self.schedule, num_steps=num_steps,
                                    generator=generator, x_init=x_init,
                                    device=self.device)
            return self.decode(latents) if decode else latents

        return sampler

    def sample(self, input_ids, attention_mask=None, num_steps=50,
               guidance_scale=7.5, generator=None, negative_input_ids=None,
               method="ddim", x_init=None, decode=True):
        """Prompts -> images [B, H, W, 3] in [-1, 1] (x_T from `generator`,
        or x_init)."""
        return self.make_sampler(num_steps, guidance_scale, method,
                                 decode)(input_ids, attention_mask,
                                         negative_input_ids, generator,
                                         x_init)

    # -- ControlNet -----------------------------------------------------------
    def make_controlnet_sampler(self, controlnet, num_steps=50,
                                guidance_scale=7.5, method="ddim",
                                control_scale=1.0):
        """sampler(input_ids, attention_mask, negative_input_ids, hint
        [B, H, W, 3] in [0, 1], generator, x_init=None) -> images. The
        residuals reach both guidance branches, scaled by control_scale."""
        sample_fn = SAMPLERS[method]

        def sampler(input_ids, attention_mask, negative_input_ids, hint,
                    generator=None, x_init=None):
            ids, mask, neg = self._ids(input_ids, attention_mask,
                                       negative_input_ids)
            hint = nchw(_device_tensor(hint, self.device))

            def control(x, t, ctx):
                downs, mid = controlnet(x, hint, t, ctx)
                return ([control_scale * d for d in downs],
                        control_scale * mid)

            with torch.inference_mode():
                denoise = self.make_denoise(ids, mask, neg, guidance_scale,
                                            control=control)
                latents = sample_fn(denoise, self.latent_shape(ids.shape[0]),
                                    self.schedule, num_steps=num_steps,
                                    generator=generator, x_init=x_init,
                                    device=self.device)
            return self.decode(latents)

        return sampler

    def init_controlnet(self, seed=0):
        """A fresh ControlNet: the UNet's down path copied into it (the
        "trainable copy"), zero convs at zero, so sampling through it gives
        the base model's output until it is trained."""
        from easynlp_tpu_torch.modelzoo.models.latent_diffusion.controlnet import (  # noqa: E501
            ControlNetModel)
        cnet = ControlNetModel(self.config, dtype=self.module.unet.dtype,
                               device=self.device)
        cnet.init_weights(torch.Generator(device=self.device)
                          .manual_seed(seed))
        cnet.copy_from_unet(self.module.unet)
        return cnet

    # -- FreePromptEditing ----------------------------------------------------
    def edit(self, source_input_ids, target_input_ids, attention_mask=None,
             num_steps=50, guidance_scale=7.5, share_frac=0.4,
             generator=None, negative_input_ids=None,
             target_attention_mask=None, x_init=None):
        """Prompt editing by self-attention map sharing: source and target
        prompts sample from one x_T; while t > the cutoff (the first
        share_frac of the steps) the target half takes the source half's
        self-attention maps. Returns images [2B, H, W, 3]: [:B] the
        source's, [B:] the edited."""
        src = _device_tensor(source_input_ids, self.device, torch.int64)
        tgt = _device_tensor(target_input_ids, self.device, torch.int64)
        ids = torch.cat([src, tgt])
        mask = None
        if attention_mask is not None:
            tmask = (target_attention_mask
                     if target_attention_mask is not None else attention_mask)
            mask = torch.cat([_device_tensor(attention_mask, self.device),
                              _device_tensor(tmask, self.device)])
        ids, mask, neg = self._ids(ids, mask, negative_input_ids)
        b = src.shape[0]
        steps = sample_steps(self.config.num_train_timesteps, num_steps)
        t_cutoff = int(steps[min(int(share_frac * num_steps),
                                 num_steps - 1)])
        if x_init is None:
            x_init = draw_normal(self.latent_shape(b), generator, self.device)
        with torch.inference_mode():
            denoise = self.make_denoise(ids, mask, neg, guidance_scale,
                                        share_self=lambda t: t[0] > t_cutoff)
            latents = ddim_sample(denoise, self.latent_shape(2 * b),
                                  self.schedule, num_steps=num_steps,
                                  x_init=torch.cat([x_init, x_init]))
        return self.decode(latents)

    # -- cross-frame video stylization ---------------------------------------
    def stylize_video(self, frames, input_ids, attention_mask=None,
                      strength=0.7, num_steps=50, guidance_scale=7.5,
                      generator=None, negative_input_ids=None,
                      temporal_blend=0.0, noise=None):
        """frames [F, H, W, 3] in [-1, 1] -> [F, H, W, 3]: img2img over all
        frames with every frame's self-attention over all frames (one
        joint sequence), the prompt broadcast to each frame; temporal_blend
        mixes each final latent with its neighbours' mean."""
        frames = _device_tensor(frames, self.device, torch.float32)
        f = frames.shape[0]
        ids = _device_tensor(input_ids, self.device, torch.int64)[:1].expand(
            f, -1)
        mask = (None if attention_mask is None else _device_tensor(
            attention_mask, self.device)[:1].expand(f, -1))
        ids, mask, neg = self._ids(ids, mask, negative_input_ids)
        with torch.inference_mode():
            denoise = self.make_denoise(ids, mask, neg, guidance_scale,
                                        cross_frame=True)
            latents0 = self.module.encode_image(nchw(frames))
            latents = ddim_img2img(denoise, latents0, self.schedule,
                                   strength=strength, num_steps=num_steps,
                                   generator=generator, noise=noise)
            if temporal_blend > 0.0:
                prev = torch.cat([latents[:1], latents[:-1]])
                nxt = torch.cat([latents[1:], latents[-1:]])
                latents = ((1.0 - temporal_blend) * latents
                           + temporal_blend * 0.5 * (prev + nxt))
        return self.decode(latents)

    # -- OLSS learned scheduler ----------------------------------------------
    def fit_olss(self, input_ids, attention_mask=None,
                 negative_input_ids=None, teacher_steps=100,
                 student_steps=10, guidance_scale=7.5, generator=None,
                 x_init=None):
        """An N-step scheduler fitted to a DDIM teacher trajectory on the
        prompts: (timesteps, wx, we) for make_olss_sampler / save_olss."""
        from easynlp_tpu_torch.modelzoo.models.latent_diffusion.olss import (
            ddim_collect_path, fit_olss)
        ids, mask, neg = self._ids(input_ids, attention_mask,
                                   negative_input_ids)
        with torch.inference_mode():
            denoise = self.make_denoise(ids, mask, neg, guidance_scale)
            t_path, x_path, e_path = ddim_collect_path(
                denoise, self.latent_shape(ids.shape[0]), self.schedule,
                num_steps=teacher_steps, generator=generator, x_init=x_init,
                device=self.device)
        return fit_olss(t_path, x_path, e_path, student_steps)

    def make_olss_sampler(self, olss_params, guidance_scale=7.5):
        """sampler(input_ids, attention_mask, negative_input_ids, generator,
        x_init=None) -> images, through the learned (timesteps, wx, we)."""
        from easynlp_tpu_torch.modelzoo.models.latent_diffusion.olss import (
            olss_sample)
        timesteps, wx, we = olss_params

        def sampler(input_ids, attention_mask, negative_input_ids,
                    generator=None, x_init=None):
            ids, mask, neg = self._ids(input_ids, attention_mask,
                                       negative_input_ids)
            if x_init is None:
                x_init = draw_normal(self.latent_shape(ids.shape[0]),
                                     generator, self.device)
            with torch.inference_mode():
                denoise = self.make_denoise(ids, mask, neg, guidance_scale)
                latents = olss_sample(denoise, x_init, timesteps, wx, we)
            return self.decode(latents)

        return sampler


def load_esrgan(model_dir, device, dtype=torch.float32):
    """The RRDBNet of `model_dir`'s ESRGAN_FLAX_NAME (the JAX package's
    file), or None where it has none."""
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import esrgan
    from easynlp_tpu_torch.utils.flax_checkpoint import load_flax_params
    path = os.path.join(model_dir, ESRGAN_FLAX_NAME)
    if not os.path.exists(path):
        return None
    return esrgan.build_rrdbnet(esrgan.state_dict_from_jax(
        load_flax_params(path)), device=device, dtype=dtype)


def upscale(net, images_pm1):
    """4x ESRGAN on [-1, 1] images [B, H, W, 3] (RRDBNet reads [0, 1])."""
    x = nchw((images_pm1 + 1.0) / 2.0)
    with torch.inference_mode():
        y = net(x)
    return y.clamp(0.0, 1.0).permute(0, 2, 3, 1) * 2.0 - 1.0


class StableDiffusionPipeline:
    """Prompts in, base64 PNG images out: tokenize the prompts and the
    negative prompts ("" when none), DDIM with guidance, an optional 4x
    ESRGAN upscale (`esrgan`: an RRDBNet, e.g. esrgan.build_rrdbnet of a
    reference checkpoint; by default the model directory's ESRGAN weights
    where it has them)."""

    def __init__(self, model_dir, num_steps=50, guidance_scale=7.5,
                 esrgan=None, args=None, dtype=torch.float32,
                 device="cuda"):
        from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
        self.app = LatentDiffusion.from_pretrained(model_dir, args=args,
                                                   dtype=dtype, device=device)
        self.tokenizer = tokenizer_for(model_dir)
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self.esrgan = esrgan if esrgan is not None else load_esrgan(
            model_dir, self.app.device)

    def upscale(self, images_pm1):
        """4x ESRGAN super-resolution of [-1, 1] images (unchanged without
        an ESRGAN)."""
        if self.esrgan is None:
            return images_pm1
        return upscale(self.esrgan, images_pm1)

    def __call__(self, prompts, negative_prompts=None, seed=0,
                 sequence_length=32, do_upscale=False):
        from easynlp_tpu_torch.data.image_utils import encode_image_base64_png
        if isinstance(prompts, str):
            prompts = [prompts]
        enc = self.tokenizer(list(prompts), max_length=sequence_length)
        if not negative_prompts:
            negative_prompts = [""] * len(prompts)
        elif isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts] * len(prompts)
        neg = self.tokenizer(list(negative_prompts),
                             max_length=sequence_length)
        images = self.app.sample(
            enc["input_ids"], enc["attention_mask"],
            num_steps=self.num_steps, guidance_scale=self.guidance_scale,
            generator=torch.Generator().manual_seed(int(seed)),
            negative_input_ids=neg["input_ids"])
        if do_upscale:
            images = self.upscale(images)
        arr = images.float().cpu().numpy()
        return [{"text": p, "image_base64": encode_image_base64_png(img)}
                for p, img in zip(prompts, arr)]
