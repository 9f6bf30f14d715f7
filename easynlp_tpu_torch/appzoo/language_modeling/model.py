"""MLM pretraining application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/language_modeling/model.py's
LanguageModeling: BertForMaskedLM (BERT, or RoBERTa when the checkpoint's
model_type says so), trained with cross-entropy over the masked positions
(label -100 elsewhere). The config follows the checkpoint's model_type
(RobertaConfig for `roberta`), and checkpoints keep the HF names of that
type (conversion.py), where the JAX app reads every checkpoint as BERT
(ROADMAP C16).

The knowledge variants (user_defined_parameters switches, appzoo/api.py):
- DKPLMLanguageModeling (`enable_dkplm`): DKPLMForPreTraining, MLM CE +
  decode-knowledge CE; checkpoints `bert.*` (with `bert.know_linear.*`)
  and `cls.predictions.*`; a BERT checkpoint starts know_linear at its
  init;
- KangarooLanguageModeling (`enable_kangaroo`): KangarooForPreTraining,
  MLM CE + the entity-sample contrast CE, its own model_input_keys;
  checkpoints under the reference Kangaroo names;
- CKBertLanguageModeling (`contrast_learning_flag`): CKBertForPreTraining,
  MLM CE + contrastive_weight x InfoNCE at contrastive_temperature, both
  read from the config (the JAX app calls the loss with its defaults
  whatever the config says: ROADMAP reference fault 21; the two agree at
  the defaults); BertForMaskedLM's checkpoint names.
Each reads the JAX package's flax_params.msgpack through its
state_dict_from_jax, and refuses, with a ValueError before the first step,
a dataset whose knowledge widths disagree with the config
(`check_dataset`), where flax would fail with a shape error inside the
step.
"""

import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.models.auto import bert_config_for
from easynlp_tpu_torch.modelzoo.models.bert import BertForMaskedLM
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    export_mlm_state_dict,
    load_mlm_state_dict,
    mlm_state_dict_from_jax,
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

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return mlm_state_dict_from_jax(params, config)


class DKPLMLanguageModeling(LanguageModeling):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids",
                        "insert_know_emb", "insert_know_position_mask")

    @staticmethod
    def loss_fn(outputs, batch):
        from easynlp_tpu_torch.modelzoo.models.dkplm import (
            dkplm_pretrain_loss)
        return dkplm_pretrain_loss(outputs, batch)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.modelzoo.models.dkplm import DKPLMConfig
        return DKPLMConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        from easynlp_tpu_torch.modelzoo.models.dkplm import (
            DKPLMConfig, DKPLMForPreTraining)
        if not isinstance(config, DKPLMConfig):
            config = DKPLMConfig.from_dict(config.to_dict())
        return DKPLMForPreTraining(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_mlm_state_dict(module, state_dict, optional=("know_linear.",))

    @classmethod
    def state_dict_from_jax(cls, params, config):
        from easynlp_tpu_torch.modelzoo.models.dkplm.modeling_dkplm import (
            state_dict_from_jax)
        state = mlm_state_dict_from_jax(params, config)
        state.update({"bert." + k: v for k, v in
                      state_dict_from_jax(params["bert"], config).items()})
        return state

    def check_dataset(self, dataset):
        want = self.config.knowledge_emb_size
        got = dataset.knowledge_emb_size
        if got != want:
            raise ValueError(
                "the entity table (entity_emb_file) is %d wide, but the "
                "config's knowledge_emb_size is %d" % (got, want))


class KangarooLanguageModeling(LanguageModeling):
    model_input_keys = ("input_ids", "attention_mask", "entities_position",
                        "ent_mask", "sample_token_id", "sample_position_id",
                        "sample_mask", "concept_emb")

    @staticmethod
    def loss_fn(outputs, batch):
        mlm = losses.cross_entropy(outputs["logits"], batch["label_ids"],
                                   ignore_index=-100)
        out = {"loss": mlm, "mlm_loss": mlm}
        if "cos_score" in outputs:
            contrast = losses.cross_entropy(outputs["cos_score"],
                                            outputs["sample_label"],
                                            ignore_index=-100)
            out["contrast_loss"] = contrast
            out["loss"] = mlm + contrast
        return out

    def export_state_dict(self):
        from easynlp_tpu_torch.modelzoo.models.kangaroo.modeling_kangaroo \
            import reference_state_dict
        return reference_state_dict(self.module)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.modelzoo.models.kangaroo import KangarooConfig
        return KangarooConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        from easynlp_tpu_torch.modelzoo.models.kangaroo import (
            KangarooConfig, KangarooForPreTraining)
        if not isinstance(config, KangarooConfig):
            config = KangarooConfig.from_dict(config.to_dict())
        return KangarooForPreTraining(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        """A reference Kangaroo checkpoint, strictly: gamma/beta renamed,
        an unprefixed backbone put under `kangaroo.`, the tied decoder and
        the pooler (not in the pretraining module) dropped, the MLM head's
        names made BertMLMHead's."""
        from easynlp_tpu_torch.modelzoo.models.kangaroo.modeling_kangaroo \
            import from_reference_names
        state = {}
        for k, v in state_dict.items():
            k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
            if k.startswith(("embeddings.", "encoder.", "pooler.")):
                k = "kangaroo." + k
            if k.startswith(("cls.predictions.decoder.", "kangaroo.pooler.")):
                continue
            state[k] = v
        module.load_state_dict(from_reference_names(state), strict=True)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        from easynlp_tpu_torch.modelzoo.models.kangaroo.modeling_kangaroo \
            import state_dict_from_jax
        return state_dict_from_jax(params, config)

    def check_dataset(self, dataset):
        c = self.config
        for name in ("ent_num", "sample_num", "concept_size"):
            want, got = getattr(c, name), getattr(dataset, name)
            if want != got:
                raise ValueError(
                    "Kangaroo's config has %s=%d, but the dataset (its "
                    "user_defined_parameters) %s=%d" % (name, want, name,
                    got))


class CKBertLanguageModeling(LanguageModeling):
    def loss_fn(self, outputs, batch):
        from easynlp_tpu_torch.modelzoo.models.ckbert import (
            ckbert_pretrain_loss)
        c = self.config
        return ckbert_pretrain_loss(
            outputs, batch, temperature=c.contrastive_temperature,
            weight=c.contrastive_weight)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.modelzoo.models.ckbert import CKBertConfig
        return CKBertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        from easynlp_tpu_torch.modelzoo.models.ckbert import (
            CKBertConfig, CKBertForPreTraining)
        if not isinstance(config, CKBertConfig):
            config = CKBertConfig.from_dict(config.to_dict())
        return CKBertForPreTraining(config, dtype=dtype, device=device)
