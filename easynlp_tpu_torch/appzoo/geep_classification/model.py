"""GEEP early-exit classification for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/geep_classification/model.py: a BERT
backbone without pooler; one shared f32 `exit_head` reads the [CLS]
vector of every layer's output; a row exits at the earliest layer whose
softmax confidence (its largest probability) reaches `exit_threshold`
(user_defined_parameters, default 0.9), else at the last layer. Training
computes every layer and weighs the exits' cross-entropies by depth.

The JAX module computes all L layers and then selects. Here, where no
gradient is taken and the module is in eval mode (evaluate, predict,
serving), the forward stops after the first layer at which every row of
the batch has exited (ROADMAP A14): it reads one flag back from the device
per layer. The early-exit forward and the all-layers forward run the same
operations on the same shapes up to that layer, so their `logits`,
`predictions`, `probabilities` and `exit_layer` agree bit for bit;
`exit_logits` then holds only the layers computed.
"""

import torch
from torch import nn

from easynlp_tpu_torch.appzoo.sequence_classification.model import (
    SequenceClassification,
)
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert import BertModel
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    app_state_dict_from_jax,
    export_app_state_dict,
    load_app_state_dict,
)
from easynlp_tpu_torch.utils import losses


class GEEPModule(nn.Module):
    def __init__(self, config, num_labels=2, exit_threshold=0.9,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.exit_threshold = float(exit_threshold)
        self.backbone = BertModel(config, dtype=dtype, add_pooling_layer=False,
                                  device=device)
        self.exit_head = nn.Linear(config.hidden_size, num_labels,
                                   device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        self.backbone.init_weights(generator)
        truncated_normal_(self.exit_head.weight,
                          self.config.initializer_range, generator)
        self.exit_head.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                all_layers=None):
        """all_layers: compute every layer (default: unless in eval mode
        with gradients off)."""
        if all_layers is None:
            all_layers = self.training or torch.is_grad_enabled()
        hidden, kv_mask = self.backbone.embed(input_ids, attention_mask,
                                              token_type_ids)
        exit_logits, confident, exited = [], [], None
        for layer in self.backbone.encoder.layer:
            hidden = layer(hidden, kv_mask)
            # one [B, E] head and one [B, C] softmax per layer in both
            # forwards, so each layer's values are the same bits whichever
            # forward computed them
            logits = self.exit_head(hidden[:, 0].float())
            exit_logits.append(logits)
            confident.append(logits.softmax(-1).amax(-1)
                             >= self.exit_threshold)
            exited = confident[-1] if exited is None \
                else exited | confident[-1]
            if not all_layers and bool(exited.all()):
                break
        exit_logits = torch.stack(exit_logits)              # [L', B, C]
        confident = torch.stack(confident)                   # [L', B]
        exit_layer = torch.where(confident.any(0),
                                 confident.int().argmax(0),
                                 len(self.backbone.encoder.layer) - 1)
        chosen = exit_logits.gather(0, exit_layer[None, :, None].expand(
            1, *exit_logits.shape[1:]))[0]                   # [B, C]
        return {"logits": chosen, "exit_logits": exit_logits,
                "exit_layer": exit_layer,
                "predictions": chosen.argmax(-1),
                "probabilities": chosen.softmax(-1)}


def geep_loss(exit_logits, labels):
    """(sum over exits of CE x depth weight (1..L normalised), the last
    exit's CE)."""
    n = exit_logits.shape[0]
    weights = torch.arange(1, n + 1, dtype=torch.float32,
                           device=exit_logits.device)
    weights = weights / weights.sum()
    per_layer = torch.stack([losses.cross_entropy(lg, labels)
                             for lg in exit_logits])
    return (per_layer * weights).sum(), per_layer[-1]


class GEEPClassification(SequenceClassification):
    @staticmethod
    def loss_fn(outputs, batch):
        loss, final = geep_loss(outputs["exit_logits"], batch["label_ids"])
        return {"loss": loss, "final_exit_loss": final}

    def export_state_dict(self):
        return export_app_state_dict(self.module, ("exit_head",))

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, num_labels=None, **kwargs):
        udp = getattr(args, "user_defined_parameters_dict", {}) if args \
            else {}
        return GEEPModule(config,
                          num_labels=num_labels or getattr(config,
                                                           "num_labels", 2),
                          exit_threshold=float(udp.get("exit_threshold",
                                                       0.9)),
                          dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_app_state_dict(module, state_dict, ("exit_head",))

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return state_dict_from_jax(params, config)


def state_dict_from_jax(params, config):
    """GEEPModule's state dict from the JAX app's params (a backbone
    without pooler, `exit_head`)."""
    return app_state_dict_from_jax(params, config, ("exit_head",))
