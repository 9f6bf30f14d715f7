"""Evaluator base for the PyTorch port.

Counterpart of easynlp_tpu/core/evaluator.py: holds the validation
DataLoader (in order, the last batch padded and flagged by `_valid`) and the
best score; subclasses implement evaluate(app) returning
[(metric, score), ...] with the primary metric first.
"""

import contextlib

import numpy as np
import torch

from easynlp_tpu_torch.data.dataset import DataLoader
from easynlp_tpu_torch.utils.global_vars import get_args


@contextlib.contextmanager
def eval_mode(module):
    """module.eval() inside the block, its previous mode restored after."""
    was_training = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was_training)


class Evaluator:
    def __init__(self, valid_dataset, eval_batch_size=None, args=None,
                 **kwargs):
        self.args = args or get_args()
        bs = eval_batch_size or self.args.eval_batch_size
        self.valid_loader = DataLoader(valid_dataset, batch_size=bs,
                                       shuffle=False)
        self.best_valid_score = float("-inf")

    @staticmethod
    def forward(app, batch):
        """The app's forward on a numpy batch, moved to app.device, in eval
        mode and under torch.inference_mode()."""
        with eval_mode(app.module), torch.inference_mode():
            inputs = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
                app.device) for k in app.model_input_keys if k in batch}
            return app.module(**inputs)

    def evaluate(self, app):
        raise NotImplementedError
