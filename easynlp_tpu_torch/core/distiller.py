"""Distillation trainers for the PyTorch port.

Counterpart of easynlp_tpu/core/distiller.py: DistillatoryTrainer (vanilla
KD; the `teacher_logits` column flows into the student app's loss),
MetaTeacherTrainer (the meta-teacher's per-sample, domain-weighted loss)
and MetaDistillationTrainer (stage 'first': attention, representation and
domain-representation transfer; stage 'second': temperature-scaled logit
distillation). The frozen teacher runs in the same step, in eval mode under
torch.no_grad(), before the student's loss.
"""

import torch

from easynlp_tpu_torch.core.trainer import Trainer
from easynlp_tpu_torch.utils.logger import logger


class DistillatoryTrainer(Trainer):
    def __init__(self, model, train_dataset, evaluator=None, **kwargs):
        if "teacher_logits" not in getattr(train_dataset, "features", {}):
            logger.warning(
                "DistillatoryTrainer: the training table has no "
                "teacher_logits column; set logits_saved_path in "
                "user_defined_parameters")
        super().__init__(model, train_dataset, evaluator=evaluator, **kwargs)


def _flag(udp, key):
    return str(udp.get(key, "True")) == "True"


class MetaTeacherTrainer(Trainer):
    """udp: use_domain_loss, use_sample_weights (True/False),
    domain_loss_weight (0.5)."""

    def __init__(self, model, train_dataset, evaluator=None,
                 user_defined_parameters=None, **kwargs):
        from easynlp_tpu_torch.distillation.distill_metakd_application \
            import meta_teacher_loss
        udp = user_defined_parameters or {}
        use_domain_loss = _flag(udp, "use_domain_loss")
        use_sample_weights = _flag(udp, "use_sample_weights")
        dlw = float(udp.get("domain_loss_weight", 0.5))

        def weighted_loss(outputs, batch):
            return meta_teacher_loss(
                outputs, batch, use_domain_loss=use_domain_loss,
                use_sample_weights=use_sample_weights,
                domain_loss_weight=dlw)

        model.loss_fn = weighted_loss
        super().__init__(model, train_dataset, evaluator=evaluator, **kwargs)


class MetaDistillationTrainer(Trainer):
    """udp: distill_stage (first|second, or 1|2; default second), T
    (stage 2's temperature, 2.0), domain_loss_weight (0.5)."""

    def __init__(self, model, train_dataset, teacher_app=None, evaluator=None,
                 user_defined_parameters=None, stage=None, temperature=None,
                 **kwargs):
        from easynlp_tpu_torch.distillation.distill_metakd_application \
            import meta_student_stage1_loss, meta_student_stage2_loss
        if teacher_app is None:
            raise ValueError("MetaDistillationTrainer needs teacher_app")
        udp = user_defined_parameters or {}
        stage = stage or udp.get("distill_stage", "second")
        stage = {"1": "first", "2": "second"}.get(str(stage), stage)
        if stage not in ("first", "second"):
            raise ValueError("distill_stage must be 'first' or 'second'")
        temperature = float(temperature or udp.get("T", 2.0))
        dlw = float(udp.get("domain_loss_weight", 0.5))
        teacher = teacher_app.module.eval()
        for p in teacher.parameters():
            p.requires_grad_(False)
        self.teacher_app = teacher_app

        def kd_loss(outputs, batch):
            with torch.no_grad():
                t_out = teacher(input_ids=batch["input_ids"],
                                attention_mask=batch.get("attention_mask"),
                                token_type_ids=batch.get("token_type_ids"),
                                domain_ids=batch.get("domain_ids"))
            if stage == "first":
                return meta_student_stage1_loss(outputs, t_out, batch,
                                                domain_loss_weight=dlw)
            return meta_student_stage2_loss(outputs, t_out,
                                            temperature=temperature)

        model.loss_fn = kd_loss
        super().__init__(model, train_dataset, evaluator=evaluator, **kwargs)
