"""LoRA application: adapter-only fine-tuning of an app through the Trainer.

Counterpart of easynlp_tpu/core/lora_app.py. The wrapper's module
(`LoRAModule`) holds the inner app's module, frozen, and the adapters
(modelzoo/lora.py). Each adapted weight carries a parametrization
(torch.nn.utils.parametrize) that merges its adapter, W + s (A B)^T,
wherever the weight is read: so the adapters take the gradient and the
base none, the inner app serves the merged weights with no copy, and
under --remat a checkpointed layer's recompute in the backward reads the
merged weights as its forward did (the losses and adapters of
--remat=none, bit for bit). The Trainer trains only the parameters that
require a gradient, the adapters (the JAX Trainer's `trainable_mask`).
Checkpoints carry
  - pytorch_model.bin        the merged weights under the inner app's names,
                             so predictors and pipelines load it as the
                             inner app's checkpoint
  - pytorch_model_lora.bin   the adapters alone ({name}.lora_a / .lora_b)
  - pytorch_model_base.bin   the frozen base (exact resume)
"""

import contextlib
import os

import torch
from torch import nn
from torch.nn.utils import parametrize

from easynlp_tpu_torch.modelzoo.lora import (
    DEFAULT_TARGETS,
    count_lora_params,
    is_transposed,
    lora_init,
    lora_merge,
    merge_weight,
)
from easynlp_tpu_torch.modelzoo.modeling_utils import (
    load_pytorch_state_dict,
    substituted,
)
from easynlp_tpu_torch.utils.logger import logger

LORA_WEIGHTS_NAME = "pytorch_model_lora.bin"
BASE_WEIGHTS_NAME = "pytorch_model_base.bin"


class _Merged(nn.Module):
    """The parametrization of one adapted weight: W -> W + s * delta. The
    adapter is read from LoRAModule's lists (held in a tuple, so they stay
    parameters of LoRAModule and not of the inner module), whatever
    tensors those hold now (whole ones while a mesh run exports). Over a
    tensor axis the factor the split leaves whole (`whole`: 'a' or 'b')
    passes through copy_to_group, so its gradient sums every rank's
    part."""

    def __init__(self, lists, index, scale, transposed):
        super().__init__()
        self.lists, self.index = lists, index
        self.scale = scale
        self.transposed = transposed
        self.whole, self.group = None, None

    def forward(self, w):
        a, b = (t[self.index] for t in self.lists)
        if self.whole is not None:
            from easynlp_tpu_torch.parallel import comm
            if self.whole == "a":
                a = comm.copy_to_group(a, self.group)
            else:
                b = comm.copy_to_group(b, self.group)
        return merge_weight(w, {"a": a, "b": b}, self.scale,
                            self.transposed)


class LoRAModule(nn.Module):
    """The inner module (frozen) with adapters on the weights `lora`
    names, merged into them by a parametrization each; the base values
    stay the inner module's parameters (`plain()` shows them under their
    own names)."""

    def __init__(self, inner, lora, scale):
        super().__init__()
        self.scale = scale
        self.names = list(lora)
        # registered before the inner module: the trained parameters are
        # named lora_a.{i} and lora_b.{i}
        self.lora_a = nn.ParameterList(lora[n]["a"] for n in self.names)
        self.lora_b = nn.ParameterList(lora[n]["b"] for n in self.names)
        for p in inner.parameters():
            p.requires_grad_(False)
        self.inner = inner
        lists = (self.lora_a, self.lora_b)
        self._merges = {n: _Merged(lists, i, scale, is_transposed(inner, n))
                        for i, n in enumerate(self.names)}
        self._attach()

    def tensor_parallel_split(self, prefix, specs, mesh):
        """After the inner module's split (sharding.apply_tensor_parallel),
        the adapters of the split weights: a column-split weight's merged
        W + s (A B)^T splits B's output features, a row-split one's A's
        input features, each as the weight's dim (sections and all); the
        other factor stays whole. Returns their specs."""
        from easynlp_tpu_torch.parallel.sharding import TensorSpec
        out = {}
        tp, index = mesh.size("tensor"), mesh.index("tensor")
        for i, name in enumerate(self.names):
            owner, attr = name.rsplit(".", 1)
            spec = specs.get("%sinner.%s.parametrizations.%s.original"
                             % (prefix, owner, attr))
            if spec is None:
                continue
            merge = self._merges[name]
            out_dim = 0 if merge.transposed else 1
            if spec.dim == out_dim:
                key, lst, dim, merge.whole = "lora_b.%d" % i, self.lora_b, \
                    1, "a"
            else:
                key, lst, dim, merge.whole = "lora_a.%d" % i, self.lora_a, \
                    0, "b"
            part = TensorSpec(dim, tp, lst[i].shape[dim], spec.sections)
            lst[i] = nn.Parameter(part.shard(lst[i].data, index))
            merge.group = mesh.group("tensor")
            out[key] = part
        return out

    @property
    def lora(self):
        return {n: {"a": a, "b": b} for n, a, b in
                zip(self.names, self.lora_a, self.lora_b)}

    def _owners(self):
        for name in self.names:
            owner, attr = name.rsplit(".", 1)
            yield name, self.inner.get_submodule(owner), attr

    def _attach(self):
        for name, owner, attr in self._owners():
            parametrize.register_parametrization(owner, attr,
                                                 self._merges[name])

    @contextlib.contextmanager
    def plain(self):
        """Inside the block the adapted weights are the inner module's
        plain parameters, the base, under their own names (for the inner
        app's export and load)."""
        for _, owner, attr in self._owners():
            parametrize.remove_parametrizations(owner, attr,
                                                leave_parametrized=False)
        try:
            yield self.inner
        finally:
            self._attach()

    def forward(self, *args, **kwargs):
        return self.inner(*args, **kwargs)


class LoRAApplication:
    """Wraps a built app and stands in for it before the Trainer, the
    evaluators and the predictors (anything else is the inner app's)."""

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
        with m.plain() as inner:
            merged = lora_merge(inner, dict(inner.named_parameters()),
                                m.lora, m.scale)
            with substituted(inner, merged):
                return self.inner.export_state_dict()

    def extra_save_artifacts(self):
        m = self.module
        adapters = {}
        for name, ad in m.lora.items():
            adapters[name + ".lora_a"] = ad["a"]
            adapters[name + ".lora_b"] = ad["b"]
        with m.plain():
            base = self.inner.export_state_dict()
        return {LORA_WEIGHTS_NAME: adapters, BASE_WEIGHTS_NAME: base}

    def restore_params(self, ckpt_dir):
        """Base and adapters from a checkpoint this wrapper wrote."""
        m = self.module
        with m.plain() as inner:
            self.inner.load_state_dict(inner, load_pytorch_state_dict(
                os.path.join(ckpt_dir, BASE_WEIGHTS_NAME)))
        self._load_adapters(os.path.join(ckpt_dir, LORA_WEIGHTS_NAME))

    def _load_adapters(self, path):
        state = load_pytorch_state_dict(path)
        with torch.no_grad():
            for name, ad in self.module.lora.items():
                ad["a"].copy_(state[name + ".lora_a"])
                ad["b"].copy_(state[name + ".lora_b"])

    @classmethod
    def load_adapter(cls, inner, ckpt_dir, rank=4, alpha=None,
                     targets=DEFAULT_TARGETS):
        """A trained adapter from a checkpoint on a freshly loaded base
        app."""
        app = cls(inner, rank=rank, alpha=alpha, targets=targets)
        app._load_adapters(os.path.join(ckpt_dir, LORA_WEIGHTS_NAME))
        return app
