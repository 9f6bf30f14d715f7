"""Latent diffusion evaluator for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/latent_diffusion/evaluator.py: the
eps-prediction loss over the validation rows with the posterior mean and a
fixed draw per batch index (t and the noise from a generator seeded with
the index), so the metric repeats across runs. An app that defines its own
`per_sample_eval_loss` (ControlNet's, which adds its residuals) is scored
by that instead. Reports ("eval_loss", -loss), higher being better.
"""

import numpy as np
import torch

from easynlp_tpu_torch.core.evaluator import Evaluator, eval_mode
from easynlp_tpu_torch.utils.logger import logger


class LDMEvaluator(Evaluator):
    def __init__(self, valid_dataset, **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)

    @staticmethod
    def draws(app, index, batch_size, latent_hw):
        """Batch `index`'s draws: t and the noise from a CPU generator
        seeded with the index (no posterior sample)."""
        d = app.draw_training_noise(
            batch_size, torch.Generator().manual_seed(index), latent_hw)
        d["posterior"] = None
        return d

    def evaluate(self, app):
        own = getattr(type(app), "per_sample_eval_loss", None)
        total, n = 0.0, 0
        with eval_mode(app.module), torch.inference_mode():
            for i, batch in enumerate(self.valid_loader):
                valid = batch.pop("_valid").astype(bool)
                tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    app.device) for k, v in batch.items()}
                hw = tensors["pixel_values"].shape[1] // 2 ** (
                    len(app.config.vae_channel_mult) - 1)
                draws = self.draws(app, i, valid.shape[0], hw)
                if own is not None:
                    per = app.per_sample_eval_loss(tensors, draws)
                else:
                    per = app.diffusion_loss(tensors, draws, per_sample=True)
                per = per.float().cpu().numpy()
                total += float(per[valid].sum())
                n += int(valid.sum())
        eval_loss = total / max(n, 1)
        logger.info("LDM eval loss: %.6f", eval_loss)
        return [("eval_loss", -eval_loss)]
