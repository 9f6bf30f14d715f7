"""Train/eval statistics for the PyTorch port.

Console lines and `events.jsonl` in the checkpoint directory, one record per
logged step or evaluation, as the JAX package's Statistics writes them, but
without its TensorBoard writer: `torch.utils.tensorboard` imports TensorFlow
where it is installed, and TensorFlow's Keras imports JAX and scikit-learn,
which the port must not load. TensorBoard scalars are ROADMAP A6b.
"""

import json
import os
import time

from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger


class Statistics:
    def __init__(self, args):
        self.args = args
        self.start = time.time()
        self.jsonl = None
        out = getattr(args, "checkpoint_dir", None)
        if out and getattr(args, "is_master_node", True):
            io.makedirs(out)
            self.jsonl = io.open(os.path.join(out, "events.jsonl"), "a")

    def _emit(self, record):
        if self.jsonl:
            self.jsonl.write(json.dumps(record) + "\n")
            self.jsonl.flush()

    def log_train(self, epoch, step, t_total, metrics, samples_per_sec=None):
        metrics = {k: float(v) for k, v in metrics.items()}
        msg = "epoch %d | step %d/%d | " % (epoch, step, t_total)
        msg += " | ".join("%s %.6g" % (k, v) for k, v in metrics.items())
        if samples_per_sec:
            msg += " | %.1f samples/s" % samples_per_sec
        msg += " | %.0fs" % (time.time() - self.start)
        logger.info(msg)
        rec = {"kind": "train", "epoch": epoch, "step": step, **metrics}
        if samples_per_sec:
            rec["samples_per_sec"] = samples_per_sec
        self._emit(rec)

    def log_eval(self, step, results):
        logger.info("eval @ step %d | " % step + " | ".join(
            "%s %.6g" % (m, s) for m, s in results))
        self._emit({"kind": "eval", "step": step,
                    **{m: float(s) for m, s in results}})

    def close(self):
        if self.jsonl:
            self.jsonl.close()
