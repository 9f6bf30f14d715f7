"""App dispatch + default main for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/api.py, reduced to what is ported: the
predict branch (api.py `_predict_main`) for `text_classify`. Every other mode,
app or app variant raises NotImplementedError naming its ROADMAP item.
"""

import json
import os

import torch

from easynlp_tpu.utils.global_vars import get_args
from easynlp_tpu.utils.io_utils import io


def _lazy(path, name):
    def load():
        import importlib
        return getattr(importlib.import_module(path), name)
    return load


MODEL_REGISTRY = {
    "text_classify": _lazy(
        "easynlp_tpu_torch.appzoo.sequence_classification.model",
        "SequenceClassification"),
}
PREDICTOR_REGISTRY = {
    "text_classify": _lazy(
        "easynlp_tpu_torch.appzoo.sequence_classification.predictor",
        "SequenceClassificationPredictor"),
}

_NOT_PORTED_MODES = {
    "train": "ROADMAP A4-A7 (losses, optimizers, Trainer)",
    "evaluate": "ROADMAP A5-A6 (Evaluator)",
    "export": "ROADMAP A26",
    "serve": "ROADMAP A17",
}
# user_defined_parameters switches that select another app variant
_VARIANT_KEYS = ("enable_metakd", "enable_distillation", "enable_fewshot",
                 "multi_label", "enable_lora")


def _resolve(registry, app_name, udp):
    if app_name not in registry:
        raise NotImplementedError(
            "app %r is not ported yet (ROADMAP A9-A22); the PyTorch port "
            "has: %s" % (app_name, sorted(registry)))
    for key in _VARIANT_KEYS:
        if udp.get(key):
            raise NotImplementedError(
                "%s=%s is not ported yet (ROADMAP A5, A12)"
                % (key, udp[key]))
    return registry[app_name]()


def default_main_fn(args=None):
    args = args or get_args()
    if args.mode != "predict":
        raise NotImplementedError(
            "--mode=%s is not ported yet (%s); the PyTorch port has "
            "--mode=predict" % (args.mode, _NOT_PORTED_MODES.get(
                args.mode, "ROADMAP A")))
    return _predict_main(args, args.user_defined_parameters_dict)


def _predict_main(args, udp):
    from easynlp_tpu_torch.core.predictor import PredictorManager
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model_cls = _resolve(MODEL_REGISTRY, args.app_name, udp)
    predictor_cls = _resolve(PREDICTOR_REGISTRY, args.app_name, udp)
    ckpt = args.predict_checkpoint_path or args.checkpoint_dir
    num_labels = 2
    label_path = os.path.join(ckpt, "label_mapping.json")
    if io.exists(label_path):
        with io.open(label_path) as f:
            num_labels = max(len(json.load(f)), 2)
    app = model_cls.from_pretrained(ckpt, args=args, dtype=dtype,
                                    device=args.device,
                                    num_labels=num_labels)
    predictor = predictor_cls(
        model_dir=ckpt, app=app,
        first_sequence=args.first_sequence,
        second_sequence=args.second_sequence,
        sequence_length=args.sequence_length,
        batch_size=args.micro_batch_size)
    manager = PredictorManager(
        predictor=predictor,
        input_file=(args.tables or "").split(",")[0],
        input_schema=args.input_schema,
        output_file=args.outputs,
        output_schema=args.output_schema,
        append_cols=args.append_cols,
        args=args)
    manager.run()
    return manager
