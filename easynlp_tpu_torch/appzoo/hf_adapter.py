"""Run stock HuggingFace `transformers` PyTorch models under the port's
Trainer/Evaluator/Predictor (the port's counterpart of
easynlp_tpu/appzoo/hf_adapter.py).

Capability parity: reference examples/hf_adapter_easynlp (HfTrainer/
HfEvaluator/HfPredictor wrap raw HF torch models into the EasyNLP loop).
Where the JAX package wraps a `FlaxPreTrainedModel`, the port wraps a
`PreTrainedModel`: its module slots into the Application contract, so the
Trainer's features (bf16 casts, grad accumulation, the non-finite skip,
checkpointing) apply to a stock HF model. `transformers` is imported by the
caller only; this module does not need it.

    from transformers import BertForSequenceClassification
    hf = BertForSequenceClassification.from_pretrained(path)
    app = HFAdapterClassification.from_hf(hf, label_mapping={"neg": 0,
                                                             "pos": 1})
    Trainer(app, train_dataset, evaluator, args=args).train()
"""

import torch
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.utils import losses


class _HFModuleShim(nn.Module):
    """The HF model under `hf_model`, called with the keyword inputs the
    Trainer passes (missing masks and token types filled in, as the JAX
    shim does); returns {'logits': ...}."""

    def __init__(self, hf_model):
        super().__init__()
        self.hf_model = hf_model

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        out = self.hf_model(input_ids=input_ids.long(),
                            attention_mask=attention_mask.long(),
                            token_type_ids=token_type_ids.long())
        return {"logits": out.logits}


class HFAdapterClassification(Application):
    """Sequence classification over any HF *ForSequenceClassification
    PyTorch model (logits head + CE loss, reference
    hf_ez_nlp_user_defined.py)."""

    model_input_keys = ("input_ids", "attention_mask", "token_type_ids")

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["label_ids"])}

    @classmethod
    def from_hf(cls, hf_model, label_mapping=None):
        """hf_model: a transformers PreTrainedModel instance (on its
        device)."""
        device = next(hf_model.parameters()).device
        return cls(_HFModuleShim(hf_model), hf_model.config, device,
                   label_mapping=label_mapping)

    def forward(self, batch):
        inputs = {k: batch[k] for k in self.model_input_keys if k in batch}
        logits = self.module(**inputs)["logits"]
        return {"logits": logits,
                "predictions": torch.argmax(logits, dim=-1),
                "probabilities": torch.softmax(logits.float(), dim=-1)}

    def export_state_dict(self):
        """The HF model's own state dict (its names, loadable by
        from_pretrained)."""
        return self.module.hf_model.state_dict()


class HFAdapterMaskedLM(HFAdapterClassification):
    """MLM over any HF *ForMaskedLM PyTorch model (label_ids = -100-masked
    positions ignored)."""

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["label_ids"],
                                             ignore_index=-100)}
