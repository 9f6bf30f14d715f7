"""Application base for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/application.py. An Application holds an
`nn.Module` (which owns its parameters), the config and the torch.device the
module lives on. `from_pretrained` reads `config.json` and
`pytorch_model.bin` from a model directory, or, where only the JAX
package's `flax_params.msgpack` is there, that file through the app's
`state_dict_from_jax` (the JAX app's parameter tree, `nn.scan`'s stacked
layers included, mapped onto the module); the Trainer computes
`loss_fn(forward outputs, batch)` and writes `export_state_dict()` back as
`pytorch_model.bin`.
"""

import os

import torch

from easynlp_tpu_torch.modelzoo.modeling_utils import (
    PARAMS_NAME,
    available_checkpoint,
    load_pytorch_state_dict,
)
from easynlp_tpu_torch.utils.logger import logger


class Application:
    """Subclasses define
      - load_config(model_dir) -> config
      - build_module(config, args, dtype, device, **kw) -> nn.Module with
        init_weights(generator)
      - load_state_dict(module, state_dict): map a reference/HF checkpoint
        onto the module
      - loss_fn(outputs, batch) -> {'loss': f32 scalar, ...} (training)
      - export_state_dict() -> the weights under reference/HF names
      - state_dict_from_jax(params, config) -> the module's state dict from
        the JAX app's parameter tree (numpy leaves), where the app reads
        JAX checkpoints
      - model_input_keys: batch keys forwarded to the module."""

    model_input_keys = ("input_ids", "attention_mask", "token_type_ids")

    def __init__(self, module, config, device, label_mapping=None):
        self.module = module
        self.config = config
        self.device = torch.device(device)
        self.label_mapping = label_mapping or {}

    def forward(self, batch):
        """Forward on a dict of tensors already on self.device (in the
        module's current train/eval mode)."""
        return self.module(**{k: batch[k] for k in self.model_input_keys
                              if k in batch})

    @staticmethod
    def loss_fn(outputs, batch):
        raise NotImplementedError

    def export_state_dict(self):
        raise NotImplementedError

    @classmethod
    def state_dict_from_jax(cls, params, config):
        raise NotImplementedError(
            "%s does not read the JAX package's flax_params.msgpack yet "
            "(ROADMAP A6)" % cls.__name__)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        raise NotImplementedError

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        raise NotImplementedError

    @classmethod
    def load_state_dict(cls, module, state_dict):
        raise NotImplementedError

    @classmethod
    def from_pretrained(cls, model_dir, args=None, label_mapping=None,
                        dtype=torch.float32, device="cuda", seed=0, **kwargs):
        """Config + weights from model_dir, in eval mode on `device`.
        Parameters the checkpoint lacks keep their init from `seed`."""
        device = torch.device(device)
        config = cls.load_config(model_dir, **kwargs)
        module = cls.build_module(config, args=args, dtype=dtype,
                                  device=device, **kwargs)
        module.init_weights(torch.Generator(device=device).manual_seed(seed))
        flavour = available_checkpoint(model_dir)
        if flavour == "pytorch":
            cls.load_state_dict(module, load_pytorch_state_dict(model_dir))
        elif flavour == "flax":
            from easynlp_tpu_torch.utils.flax_checkpoint import (
                load_flax_params)
            params = load_flax_params(os.path.join(model_dir, PARAMS_NAME))
            module.load_state_dict(cls.state_dict_from_jax(params, config),
                                   strict=True)
        else:
            logger.warning("no weights found in %s; random init", model_dir)
        return cls(module.eval(), config, device, label_mapping=label_mapping)
