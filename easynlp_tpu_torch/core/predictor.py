"""Predictor stack for the PyTorch port.

Counterpart of easynlp_tpu/core/predictor.py: `Predictor` with
run = postprocess(predict(preprocess(x))), `PyModelPredictor` (batches ->
device -> forward -> numpy), and `PredictorManager`, which streams a TSV file
through a predictor and writes the output_schema (+ append_cols) columns.

PyTorch runs eagerly, so a partial last batch runs at its own size; the JAX
predictor pads it to keep one compiled shape.
"""

import time

import numpy as np
import torch

from easynlp_tpu_torch.utils import parse_row_by_schema
from easynlp_tpu_torch.utils.global_vars import get_args
from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger


class Predictor:
    def preprocess(self, in_data):
        raise NotImplementedError

    def predict(self, in_data):
        raise NotImplementedError

    def postprocess(self, result):
        raise NotImplementedError

    def run(self, in_data):
        return self.postprocess(self.predict(self.preprocess(in_data)))


class PyModelPredictor(Predictor):
    """Wraps an Application: typed input keys -> app.device -> forward under
    torch.inference_mode() -> numpy outputs.

    `batch_seconds` records each batch's host-clock time from the copy of its
    inputs to the device to its outputs back on the host (the copy back waits
    for the device)."""

    def __init__(self, app, input_keys, output_keys, batch_size=32):
        self.app = app
        self.input_keys = input_keys      # [(name, numpy dtype), ...]
        self.output_keys = output_keys    # output dict keys to fetch
        self.batch_size = batch_size
        self.batch_seconds = []

    def predict(self, in_data):
        bs = self.batch_size
        arrays = {k: np.ascontiguousarray(np.asarray(in_data[k], dtype=d))
                  for k, d in self.input_keys}
        # row count from the model inputs (preprocessors may expand rows)
        n = len(next(iter(arrays.values())))
        outs = []
        with torch.inference_mode():
            for start in range(0, n, bs):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v[start:start + bs]).to(
                    self.app.device) for k, v in arrays.items()}
                res = self.app.forward(batch)
                outs.append({k: res[k].cpu().numpy()
                             for k in self.output_keys if k in res})
                self.batch_seconds.append(time.perf_counter() - t0)
        if not outs:  # empty input: empty output columns
            merged = {k: np.zeros((0,)) for k in self.output_keys}
        else:
            merged = {k: np.concatenate([o[k] for o in outs])
                      for k in outs[0]}
        # inputs pass through without overwriting model outputs
        for k, v in in_data.items():
            merged.setdefault(k, v)
        return merged


class PredictorManager:
    """Streams input_file through predictor in slices and writes a TSV.
    After run(), `n_rows` and `seconds` hold the rows written and the host
    clock time of the whole run (read, tokenise, predict, write)."""

    def __init__(self, predictor, input_file, input_schema, output_file,
                 output_schema, append_cols=None, skip_first_line=False,
                 batch_size=None, args=None):
        self.predictor = predictor
        self.input_file = input_file
        self.input_schema = input_schema
        self.output_file = output_file
        self.output_schema = ([c for c in output_schema.split(",") if c]
                              if isinstance(output_schema, str)
                              else output_schema)
        self.append_cols = ([c for c in (append_cols or "").split(",") if c]
                            if isinstance(append_cols, str)
                            else (append_cols or []))
        self.skip_first_line = skip_first_line
        self.args = args or get_args()
        self.batch_size = batch_size or self.args.predict_slice_size
        self.n_rows = 0
        self.seconds = 0.0

    def _chunks(self, f):
        """Stream the file in batch_size slices: a large TSV is never held
        whole in host memory."""
        first = self.skip_first_line
        chunk = []
        for line in f:
            if first:
                first = False
                continue
            if not line.strip():
                continue
            chunk.append(line)
            if len(chunk) == self.batch_size:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    def run(self):
        t0 = time.perf_counter()
        n_out = 0
        with io.open(self.input_file) as f, \
                io.open(self.output_file, "w") as out:
            for chunk in self._chunks(f):
                rows = [parse_row_by_schema(line, self.input_schema)
                        for line in chunk]
                in_data = {k: [r[k] for r in rows] for k in rows[0]}
                result = self.predictor.run(in_data)
                for i in range(len(rows)):
                    cols = [str(_at(result[c], i)) for c in self.output_schema]
                    cols += [str(_at(in_data[c], i)) for c in self.append_cols]
                    out.write("\t".join(cols) + "\n")
                    n_out += 1
        self.n_rows = n_out
        self.seconds = time.perf_counter() - t0
        logger.info("wrote %d predictions to %s", n_out, self.output_file)


def _at(value, i):
    v = value[i]
    if isinstance(v, (np.ndarray, list, tuple)):
        return " ".join(str(x) for x in np.asarray(v).reshape(-1))
    return v
