"""Pipeline implementation for the PyTorch port (counterpart of
easynlp_tpu/pipelines/implementation.py: batch raw inputs through the app's
predictor and return per-example dicts)."""

import json
import os

import torch

from easynlp_tpu_torch.utils.global_vars import parse_user_defined_parameters
from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger


class Pipeline:
    """task: a key of SUPPORTED_TASKS that the port runs; model_path: a
    model directory (config.json, weights, vocabulary, and for the
    classifiers label_mapping.json). The app runs on `device` ("cuda"
    unless the caller asks for "cpu") in `dtype`; quantize="int8" turns the
    app's weights into weight-only int8 (the tensors the JAX package
    quantizes, dequantized in each forward), and params_dtype (e.g.
    "bfloat16") then casts the rest for serving
    (modelzoo/quantization.py). A diffusion task runs
    appzoo/latent_diffusion's StableDiffusionPipeline (prompts of at most
    77 tokens), as the JAX Pipeline does."""

    def __init__(self, task, model_path, first_sequence="first_sequence",
                 second_sequence=None, sequence_length=128, batch_size=32,
                 dtype=torch.bfloat16, quantize=None, params_dtype=None,
                 device="cuda"):
        from easynlp_tpu_torch.appzoo.api import (
            MODEL_REGISTRY,
            PREDICTOR_REGISTRY,
            _resolve,
        )
        from easynlp_tpu_torch.pipelines import SUPPORTED_TASKS
        spec = SUPPORTED_TASKS[task]
        self._diffusion = None
        if spec.get("diffusion"):
            from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
                StableDiffusionPipeline)
            self._diffusion = StableDiffusionPipeline(
                model_path, dtype=dtype, device=device)
            self.app = self._diffusion.app
            self.device = self.app.device
            self.sequence_length = sequence_length
            return
        if quantize and quantize != "int8":
            raise ValueError("quantize must be 'int8' (got %r)"
                             % (quantize,))
        # choose the app variant from the saved train_config when present
        udp = {}
        tc = os.path.join(model_path, "train_config.json")
        if io.exists(tc):
            with io.open(tc) as f:
                saved = json.load(f)
            udp = parse_user_defined_parameters(
                saved.get("user_defined_parameters"))
        app_cls = _resolve(MODEL_REGISTRY, spec["app"], udp)
        predictor_cls = _resolve(PREDICTOR_REGISTRY, spec["app"], udp)
        num_labels = 2
        lm = os.path.join(model_path, "label_mapping.json")
        if io.exists(lm):
            with io.open(lm) as f:
                num_labels = max(len(json.load(f)), 2)
        app = app_cls.from_pretrained(model_path, dtype=dtype, device=device,
                                      num_labels=num_labels)
        if quantize:
            from easynlp_tpu_torch.modelzoo.quantization import (
                quantization_report, quantize_params)
            quantize_params(app.module)
            qb, ob, n = quantization_report(app.module)
            logger.info("int8 weight quantization: %d kernels, params "
                        "%.1f MB -> %.1f MB", n, ob / 1e6, qb / 1e6)
        if params_dtype:
            from easynlp_tpu_torch.modelzoo.quantization import cast_params
            cast_params(getattr(app.module, "backbone", app.module),
                        params_dtype)
        self.app = app
        self.device = app.device
        self.first_sequence = first_sequence
        self.second_sequence = second_sequence
        self.predictor = predictor_cls(
            model_path, app, first_sequence=first_sequence,
            second_sequence=second_sequence, sequence_length=sequence_length,
            batch_size=batch_size, user_defined_parameters=udp)

    def __call__(self, inputs):
        """inputs: str | list[str] | list[(a, b)] -> list of result dicts."""
        single = isinstance(inputs, str)
        if single:
            inputs = [inputs]
        if self._diffusion is not None:
            rows = self._diffusion(
                list(inputs), sequence_length=min(self.sequence_length, 77))
            return rows[0] if single else rows
        if inputs and isinstance(inputs[0], (tuple, list)):
            # resolve the pair column the predictor will actually read: an
            # explicit second_sequence, the predictor's own default (e.g.
            # MRC's "context"), or wire the fallback key into the predictor
            # so pair inputs are consumed rather than silently ignored
            second = (self.second_sequence
                      or getattr(self.predictor, "second_sequence", None)
                      or getattr(self.predictor, "context_col", None))
            if not second:
                second = "second_sequence"
                if hasattr(self.predictor, "second_sequence"):
                    self.predictor.second_sequence = second
            data = {self.first_sequence: [a for a, _ in inputs],
                    second: [b for _, b in inputs]}
        else:
            data = {self.first_sequence: list(inputs)}
        result = self.predictor.run(data)
        n = len(inputs)
        keys = [k for k, v in result.items()
                if isinstance(v, (list, tuple)) and len(v) == n
                and not k.startswith("_")]
        rows = [{k: result[k][i] for k in keys} for i in range(n)]
        return rows[0] if single else rows
