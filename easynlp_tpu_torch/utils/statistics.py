"""Train/eval statistics for the PyTorch port.

The JAX package's Statistics (console lines and `events.jsonl` in the
checkpoint directory, one record per logged step or evaluation), without its
TensorBoard writer: `torch.utils.tensorboard` imports TensorFlow where it is
installed, and TensorFlow's Keras imports JAX and scikit-learn, which the
port must not load. TensorBoard scalars are ROADMAP A6b.
"""

import os
import time

from easynlp_tpu.utils.io_utils import io
from easynlp_tpu.utils.statistics import Statistics as _Statistics


class Statistics(_Statistics):
    def __init__(self, args):
        self.args = args
        self.start = time.time()
        self.jsonl = None
        self.tb = None
        out = getattr(args, "checkpoint_dir", None)
        if out and getattr(args, "is_master_node", True):
            io.makedirs(out)
            self.jsonl = io.open(os.path.join(out, "events.jsonl"), "a")
