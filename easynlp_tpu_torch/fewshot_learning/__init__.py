"""Few-shot learning for the PyTorch port: PET (cloze classification with
the MLM head) and CPT (PET plus a contrastive loss)."""
