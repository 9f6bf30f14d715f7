"""LoRA application: adapter-only fine-tuning of an app through the Trainer.

Counterpart of easynlp_tpu/core/lora_app.py. The wrapper's module
(`LoRAModule`) holds the inner app's module, frozen, and the adapters
(modelzoo/lora.py); its forward merges them into the adapted weights and
runs the inner module on the merged weights through
torch.func.functional_call, so the adapters take the gradient and the
base none. The Trainer trains only the parameters that require a
gradient, the adapters (the JAX Trainer's `trainable_mask`). Checkpoints
carry
  - pytorch_model.bin        the merged weights under the inner app's names,
                             so predictors and pipelines load it as the
                             inner app's checkpoint
  - pytorch_model_lora.bin   the adapters alone ({name}.lora_a / .lora_b)
  - pytorch_model_base.bin   the frozen base (exact resume)
"""

import os

import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.lora import (
    DEFAULT_TARGETS,
    count_lora_params,
    lora_apply,
    lora_init,
    lora_merge,
)
from easynlp_tpu_torch.modelzoo.modeling_utils import (
    load_pytorch_state_dict,
    substituted,
)
from easynlp_tpu_torch.utils.logger import logger

LORA_WEIGHTS_NAME = "pytorch_model_lora.bin"
BASE_WEIGHTS_NAME = "pytorch_model_base.bin"


class LoRAModule(nn.Module):
    """The inner module (frozen) with adapters on the weights `lora` names.
    `base` keeps the adapted weights' base values apart from the inner
    module's own, which sync_merged() overwrites with the merged ones."""

    def __init__(self, inner, lora, scale):
        super().__init__()
        self.inner = inner
        for p in inner.parameters():
            p.requires_grad_(False)
        self.scale = scale
        self.names = list(lora)
        self.lora_a = nn.ParameterList(lora[n]["a"] for n in self.names)
        self.lora_b = nn.ParameterList(lora[n]["b"] for n in self.names)
        params = dict(inner.named_parameters())
        self.base = {n: params[n].detach().clone() for n in self.names}

    @property
    def lora(self):
        return {n: {"a": a, "b": b} for n, a, b in
                zip(self.names, self.lora_a, self.lora_b)}

    def merged(self):
        return lora_apply(self.inner, self.base, self.lora, self.scale)

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.inner, self.merged(), args,
                                          kwargs)

    def sync_merged(self):
        """The inner module's adapted weights := the merged ones."""
        with torch.no_grad():
            params = dict(self.inner.named_parameters())
            for name, w in lora_merge(self.inner, self.base, self.lora,
                                      self.scale).items():
                params[name].copy_(w)


class LoRAApplication:
    """Wraps a built app and stands in for it before the Trainer, the
    evaluators and the predictors (anything else is the inner app's)."""

    # functional_call's weights last only for the forward, and a layer's
    # recompute in the backward would read the base ones
    remat_unsupported = ("--remat with enable_lora: the layers' recompute "
                         "would read the base weights, not the merged ones "
                         "(ROADMAP A12)")

    def __init__(self, inner, rank=4, alpha=None, targets=DEFAULT_TARGETS,
                 seed=0, lora=None):
        self.inner = inner
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scale = self.alpha / self.rank
        self.targets = targets
        if lora is None:
            lora = lora_init(inner.module, rank=self.rank, targets=targets,
                             seed=seed)
        if not lora:
            raise ValueError("lora_targets %s match no weight of %s"
                             % (",".join(targets), type(inner).__name__))
        self.module = LoRAModule(inner.module, lora, self.scale)
        self.config = inner.config
        self.device = inner.device
        self.label_mapping = inner.label_mapping
        self.model_input_keys = inner.model_input_keys
        logger.info("LoRA r=%d alpha=%.1f: %d adapter params over %d "
                    "weights", self.rank, self.alpha,
                    count_lora_params(lora), len(lora))

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def forward(self, batch):
        return self.module(**{k: batch[k] for k in self.model_input_keys
                              if k in batch})

    def loss_fn(self, outputs, batch):
        return self.inner.loss_fn(outputs, batch)

    # -- the Trainer's checkpoint hooks ----------------------------------
    def export_state_dict(self):
        """The merged weights under the inner app's names."""
        m = self.module
        with substituted(m.inner, lora_merge(m.inner, m.base, m.lora,
                                             m.scale)):
            return self.inner.export_state_dict()

    def extra_save_artifacts(self):
        m = self.module
        adapters = {}
        for name, ad in m.lora.items():
            adapters[name + ".lora_a"] = ad["a"]
            adapters[name + ".lora_b"] = ad["b"]
        with substituted(m.inner, m.base):
            base = self.inner.export_state_dict()
        return {LORA_WEIGHTS_NAME: adapters, BASE_WEIGHTS_NAME: base}

    def restore_params(self, ckpt_dir):
        """Base and adapters from a checkpoint this wrapper wrote."""
        m = self.module
        self.inner.load_state_dict(m.inner, load_pytorch_state_dict(
            os.path.join(ckpt_dir, BASE_WEIGHTS_NAME)))
        params = dict(m.inner.named_parameters())
        with torch.no_grad():
            for name in m.names:
                m.base[name].copy_(params[name])
        self._load_adapters(os.path.join(ckpt_dir, LORA_WEIGHTS_NAME))

    def _load_adapters(self, path):
        state = load_pytorch_state_dict(path)
        with torch.no_grad():
            for name, ad in self.module.lora.items():
                ad["a"].copy_(state[name + ".lora_a"])
                ad["b"].copy_(state[name + ".lora_b"])

    def sync_trained_params(self):
        """The inner app serves the merged weights (before each evaluation
        and after training, as in the JAX Trainer)."""
        self.module.sync_merged()

    @classmethod
    def load_adapter(cls, inner, ckpt_dir, rank=4, alpha=None,
                     targets=DEFAULT_TARGETS):
        """A trained adapter from a checkpoint on a freshly loaded base
        app."""
        app = cls(inner, rank=rank, alpha=alpha, targets=targets)
        app._load_adapters(os.path.join(ckpt_dir, LORA_WEIGHTS_NAME))
        return app
