"""MLM pretraining application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/language_modeling/model.py's
LanguageModeling: BertForMaskedLM (BERT, or RoBERTa when the checkpoint's
model_type says so), trained with cross-entropy over the masked positions
(label -100 elsewhere). The config follows the checkpoint's model_type
(RobertaConfig for `roberta`), and checkpoints keep the HF names of that
type (conversion.py), where the JAX app reads every checkpoint as BERT
(ROADMAP C16). The DKPLM, Kangaroo and CKBERT variants are not ported
(appzoo/api.py refuses them).
"""

import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.models.auto import bert_config_for
from easynlp_tpu_torch.modelzoo.models.bert import BertForMaskedLM
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    export_mlm_state_dict,
    load_mlm_state_dict,
)
from easynlp_tpu_torch.utils import losses


class LanguageModeling(Application):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids")

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["label_ids"],
                                             ignore_index=-100)}

    def export_state_dict(self):
        return export_mlm_state_dict(self.module)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return bert_config_for(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return BertForMaskedLM(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_mlm_state_dict(module, state_dict)
