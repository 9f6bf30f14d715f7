"""ControlNet fine-tuning for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/latent_diffusion/controlnet_app.py:
wraps a LatentDiffusion app so the Trainer trains a ControlNet (its
encoder copied from the UNet, zero convs at zero) while the base model
stays frozen: the base's parameters do not require a gradient, so the
Trainer gives them no optimizer state and no update (the JAX Trainer's
`trainable_mask`). The loss is the base's eps loss with the ControlNet's
residuals added; the hint is the batch's `hint_values` (the
controlnet_hint_column) or the training image's edge map (`edge_hint`).

The Trainer evaluates the wrapper itself (`eval_target`): its
`per_sample_eval_loss` adds the residuals, where the base alone would
score a constant. Checkpoints hold the unchanged base as
`pytorch_model.bin` (so every predictor and pipeline reads them) and the
ControlNet alone as `pytorch_model_control.bin`.
"""

import os

import torch
from torch import nn

from easynlp_tpu_torch.appzoo.latent_diffusion.model import nchw
from easynlp_tpu_torch.modelzoo.models.latent_diffusion import conversion
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.controlnet import (
    ControlNetModel,
    edge_hint,
)
from easynlp_tpu_torch.utils.logger import logger

CONTROL_WEIGHTS_NAME = "pytorch_model_control.bin"


def _control_state(ckpt_dir):
    """The ControlNet state dict of a checkpoint directory (a published
    checkpoint's `control_model.*` names taken too)."""
    return conversion.normalize_controlnet_keys(torch.load(
        os.path.join(ckpt_dir, CONTROL_WEIGHTS_NAME), map_location="cpu",
        weights_only=True))


class _Composite(nn.Module):
    """The trained state: the frozen base and the ControlNet."""

    def __init__(self, base, control):
        super().__init__()
        self.base = base
        self.control = control


class ControlNetApplication:
    """Quacks like an Application for the Trainer and the evaluator."""

    def __init__(self, inner, controlnet=None, hint_type="edge", seed=0):
        self.inner = inner
        self.config = inner.config
        self.device = inner.device
        self.label_mapping = inner.label_mapping
        self.model_input_keys = inner.model_input_keys
        self.hint_type = hint_type
        if hint_type != "edge":
            raise ValueError("unknown hint_type %r" % hint_type)
        self.controlnet = controlnet if controlnet is not None else \
            inner.init_controlnet(seed=seed)
        for p in inner.module.parameters():
            p.requires_grad_(False)
        self.module = _Composite(inner.module, self.controlnet)
        self.eval_target = self
        logger.info("ControlNet finetune: %d trainable params, hint=%s",
                    sum(p.numel() for p in self.controlnet.parameters()),
                    hint_type)

    def hint(self, batch):
        """[B, 3, H, W] in [0, 1]: the batch's hint_values, else the image's
        edges."""
        if "hint_values" in batch:
            return nchw(batch["hint_values"])
        return nchw(edge_hint(batch["pixel_values"]))

    def _control(self, batch):
        hint = self.hint(batch)
        return lambda noisy, t, context: self.controlnet(noisy, hint, t,
                                                         context)

    def make_train_loss(self):
        def loss_fn(batch, generator):
            return {"loss": self.inner.diffusion_loss(
                batch, self.inner.draw_step_noise(batch, generator),
                control=self._control(batch))}
        return loss_fn

    def per_sample_eval_loss(self, batch, draws):
        """The per-row eps loss with the residuals (LDMEvaluator's hook)."""
        return self.inner.diffusion_loss(batch, draws,
                                         control=self._control(batch),
                                         per_sample=True)

    def draw_training_noise(self, *args, **kwargs):
        return self.inner.draw_training_noise(*args, **kwargs)

    # -- checkpoints ----------------------------------------------------------
    def export_state_dict(self):
        """The unchanged base, under its own names."""
        return self.inner.export_state_dict()

    def extra_save_artifacts(self):
        return {CONTROL_WEIGHTS_NAME: self.controlnet.state_dict()}

    def restore_params(self, ckpt_dir):
        from easynlp_tpu_torch.modelzoo.modeling_utils import (
            load_pytorch_state_dict)
        self.inner.load_state_dict(self.inner.module,
                                   load_pytorch_state_dict(ckpt_dir))
        self.controlnet.load_state_dict(_control_state(ckpt_dir))

    @classmethod
    def load_control(cls, inner, ckpt_dir, hint_type="edge"):
        """A trained ControlNet from a checkpoint, on a loaded base."""
        cnet = ControlNetModel(inner.config, dtype=inner.module.unet.dtype,
                               device=inner.device)
        cnet.load_state_dict(_control_state(ckpt_dir))
        return cls(inner, controlnet=cnet.eval(), hint_type=hint_type)

    # -- inference ------------------------------------------------------------
    def sample(self, input_ids, attention_mask, negative_input_ids, hint,
               generator=None, num_steps=50, guidance_scale=7.5,
               method="ddim", control_scale=1.0, x_init=None):
        """hint [B, H, W, 3] in [0, 1] -> images [B, H, W, 3]."""
        return self.inner.make_controlnet_sampler(
            self.controlnet, num_steps=num_steps,
            guidance_scale=guidance_scale, method=method,
            control_scale=control_scale)(input_ids, attention_mask,
                                         negative_input_ids, hint, generator,
                                         x_init)
