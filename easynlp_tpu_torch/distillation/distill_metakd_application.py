"""MetaKD for the PyTorch port: meta-teacher learning and meta-distillation.

Counterpart of easynlp_tpu/distillation/distill_metakd_application.py:
`MetaTeacherModule` (BERT, a ReLU-pooled f32 classifier and the
domain-corrupt head: the mean of the non-CLS tokens plus a domain
embedding through a tanh dense layer into a domain classifier),
`MetaStudentModule` (the same, and `fit_dense` projecting every layer's
hidden state into the teacher's width), and the losses: the meta-teacher's
per-sample CE plus the domain CE against a rolled domain assignment,
weighted per sample; stage 1's attention, representation and
domain-representation transfer weighted by the teacher's confidence; stage
2's temperature-scaled logit distillation.

Both modules ask BERT for `output_attentions`, its masked pre-softmax
scores, so BERT computes attention on its explicit einsum-and-softmax path,
as the JAX modules do: MetaKD launches no attention kernel in either
package.
"""

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    app_state_dict_from_jax,
    export_app_state_dict,
    load_app_state_dict,
)
from easynlp_tpu_torch.utils import losses

TEACHER_HEADS = ("classifier", "corrupt_dense", "domain_classifier",
                 "domain_embedding")
STUDENT_HEADS = TEACHER_HEADS + ("fit_dense",)


class MetaTeacherModule(nn.Module):
    heads = TEACHER_HEADS

    def __init__(self, config, num_labels=2, num_domains=4,
                 dtype=torch.float32, device=None):
        super().__init__()
        c = config
        self.config = c
        self.backbone = BertModel(c, dtype=dtype, device=device,
                                  output_hidden_states=True,
                                  output_attentions=True)
        self.classifier = nn.Linear(c.hidden_size, num_labels, device=device)
        self.domain_embedding = nn.Embedding(num_domains, c.hidden_size,
                                             device=device)
        self.corrupt_dense = nn.Linear(c.hidden_size, c.hidden_size,
                                       device=device)
        self.domain_classifier = nn.Linear(c.hidden_size, num_domains,
                                           device=device)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    @torch.no_grad()
    def init_weights(self, generator):
        self.backbone.init_weights(generator)
        for name in self.heads:
            head = getattr(self, name)
            truncated_normal_(head.weight, self.config.initializer_range,
                              generator)
            if isinstance(head, nn.Linear):
                head.bias.zero_()

    def _encode(self, input_ids, attention_mask, token_type_ids):
        out = self.backbone(input_ids, attention_mask=attention_mask,
                            token_type_ids=token_type_ids)
        logits = self.classifier(F.relu(out["pooler_output"].float()))
        return out, {
            "logits": logits, "hidden_states": out["hidden_states"],
            "attentions": out["attentions"],
            "predictions": logits.argmax(dim=-1),
            "probabilities": logits.softmax(dim=-1)}

    def _content(self, out, domain_ids):
        """domain embedding + mean of the non-CLS tokens, f32 [B, E]."""
        return self.domain_embedding(domain_ids) + \
            out["last_hidden_state"][:, 1:, :].float().mean(dim=1)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                domain_ids=None):
        out, result = self._encode(input_ids, attention_mask,
                                      token_type_ids)
        if domain_ids is not None:
            corrupt = self.dropout(torch.tanh(self.corrupt_dense(
                self._content(out, domain_ids))))
            result["domain_content_output"] = corrupt
            result["domain_logits"] = self.domain_classifier(corrupt)
        return result


class MetaStudentModule(MetaTeacherModule):
    heads = STUDENT_HEADS

    def __init__(self, config, num_labels=2, num_domains=4, fit_size=768,
                 dtype=torch.float32, device=None):
        super().__init__(config, num_labels=num_labels,
                         num_domains=num_domains, dtype=dtype, device=device)
        self.fit_dense = nn.Linear(config.hidden_size, fit_size,
                                   device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                domain_ids=None):
        out, result = self._encode(input_ids, attention_mask,
                                      token_type_ids)
        # every layer's hidden state in the teacher's width [L, B, S, fit]
        result["sequence_output"] = self.fit_dense(
            out["hidden_states"].float())
        if domain_ids is not None:
            corrupt = self.corrupt_dense(self._content(out, domain_ids))
            result["domain_content_output"] = self.fit_dense(corrupt)
            result["domain_logits"] = self.domain_classifier(
                torch.tanh(corrupt))
        return result


# ---------------------------------------------------------------- losses

def meta_teacher_loss(outputs, batch, use_domain_loss=True,
                      use_sample_weights=True, domain_loss_weight=0.5):
    """Per-sample CE, plus domain_loss_weight x the domain CE against the
    domains rolled by one row (the JAX package's static stand-in for the
    reference's random permutation), weighted per sample."""
    per_instance = losses.per_sample_cross_entropy(outputs["logits"],
                                                   batch["label_ids"])
    extras = {}
    if use_domain_loss and "domain_logits" in outputs:
        dom = losses.per_sample_cross_entropy(
            outputs["domain_logits"], torch.roll(batch["domain_ids"], 1, 0))
        per_instance = per_instance + domain_loss_weight * dom
        extras["domain_loss"] = dom.mean()
    if use_sample_weights and "sample_weights" in batch:
        loss = torch.mean(per_instance * batch["sample_weights"])
    else:
        loss = torch.mean(per_instance)
    return dict(extras, loss=loss)


def _per_sample_mse(a, b):
    """Mean square difference per batch element of [L, B, ...] tensors."""
    d = (a.float() - b.float()) ** 2
    return d.mean(dim=tuple(i for i in range(d.dim()) if i != 1))


def meta_student_stage1_loss(student_out, teacher_out, batch,
                             domain_loss_weight=0.5):
    """Attention, representation and domain-representation transfer, with
    student layer i matched to teacher layer (i + 1) * block - 1 and each
    sample weighted by (1 + sample_weight) x the teacher's confidence in
    the label."""
    s_atts, t_atts = student_out["attentions"], teacher_out["attentions"]
    s_reps = student_out["sequence_output"]
    t_reps = teacher_out["hidden_states"]
    ls, lt = s_atts.shape[0], t_atts.shape[0]
    block = lt // ls
    pick = torch.arange(ls, device=s_atts.device) * block + block - 1
    t_atts = t_atts.index_select(0, pick)
    t_reps = t_reps.index_select(0, pick)
    # masked score lanes (-1e4) do not count
    s_atts = torch.where(s_atts <= -1e2, 0.0, s_atts)
    t_atts = torch.where(t_atts <= -1e2, 0.0, t_atts)
    att_loss = _per_sample_mse(s_atts, t_atts)
    rep_loss = _per_sample_mse(s_reps, t_reps)
    domain_loss = ((student_out["domain_content_output"].float()
                    - teacher_out["domain_content_output"].float()) ** 2
                   ).mean(dim=-1)
    probs = teacher_out["logits"].float().softmax(dim=-1)
    onehot = F.one_hot(batch["label_ids"].long(), probs.shape[-1]).float()
    grt = 1.0 / (torch.exp((((probs - onehot) * onehot) ** 2).sum(-1))
                 + 1.0)
    sample_weights = batch.get("sample_weights")
    if sample_weights is None:
        sample_weights = torch.ones_like(grt)
    final_w = (1.0 + sample_weights) * grt
    loss = torch.mean((rep_loss + att_loss
                       + domain_loss_weight * domain_loss) * final_w)
    return {"loss": loss, "att_loss": att_loss.mean(),
            "rep_loss": rep_loss.mean(), "domain_loss": domain_loss.mean()}


def meta_student_stage2_loss(student_out, teacher_out, temperature=2.0):
    """Soft CE of the student's logits / T against softmax(teacher / T)."""
    t = float(temperature)
    soft = (teacher_out["logits"].float() / t).softmax(dim=-1)
    return {"loss": losses.soft_cross_entropy(
        student_out["logits"].float() / t, soft)}


# ----------------------------------------------------------- applications

class MetaTeacherClassification(Application):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids",
                        "domain_ids")

    @staticmethod
    def loss_fn(outputs, batch):
        return meta_teacher_loss(outputs, batch)

    def export_state_dict(self):
        return export_app_state_dict(self.module, self.module.heads)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, num_labels=None, num_domains=None,
                     **kwargs):
        return MetaTeacherModule(
            config, num_labels=num_labels or getattr(config, "num_labels", 2),
            num_domains=num_domains or getattr(config, "num_domains", 4),
            dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_app_state_dict(module, state_dict, module.heads)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        dense = tuple(h for h in STUDENT_HEADS
                      if h != "domain_embedding" and h in params)
        state = app_state_dict_from_jax(params, config, dense)
        state["domain_embedding.weight"] = torch.tensor(
            params["domain_embedding"]["embedding"], dtype=torch.float32)
        return state


class MetaStudentClassification(MetaTeacherClassification):
    @staticmethod
    def loss_fn(outputs, batch):
        # the student's own fine-tune and evaluation; the distillation
        # losses come from MetaDistillationTrainer
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["label_ids"])}

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, num_labels=None, num_domains=None,
                     fit_size=None, **kwargs):
        return MetaStudentModule(
            config, num_labels=num_labels or getattr(config, "num_labels", 2),
            num_domains=num_domains or getattr(config, "num_domains", 4),
            fit_size=fit_size or getattr(config, "fit_size", 768),
            dtype=dtype, device=device)
