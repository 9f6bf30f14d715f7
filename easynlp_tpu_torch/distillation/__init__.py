"""Knowledge distillation for the PyTorch port: vanilla KD against saved
teacher logits, and MetaKD (meta-teacher, then two-stage meta-distillation)."""
