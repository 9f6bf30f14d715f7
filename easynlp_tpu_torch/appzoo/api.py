"""App dispatch + default main for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/api.py, reduced to what is ported: the
train, evaluate and predict branches for the BERT apps `text_classify`,
`text_match` (cross-encoder; two-tower with user_defined_parameters
two_tower or siamese), `sequence_labeling` and
`machine_reading_comprehension`, predict for `vectorization`, and for
`sequence_generation` train, evaluate and predict on BART and predict on
GPT-2. The registries map each app to its variants, as the JAX package's
do. Every other mode, app, backbone or app variant raises
NotImplementedError naming its ROADMAP item. The datasets are the port's
copies of the JAX package's, so both packages featurise and batch the same
rows the same way.
"""

import json
import os

import torch

from easynlp_tpu_torch.modelzoo.models.auto import model_type_of, tokenizer_for
from easynlp_tpu_torch.utils.global_vars import get_args
from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger


def _lazy(path, name):
    def load():
        import importlib
        return getattr(importlib.import_module(path), name)
    return load


_P = "easynlp_tpu_torch.appzoo."
_TWO_TOWER = ("two_tower", "siamese")  # both select the shared-tower app


def _apps(**apps):
    """{app: {variant: loader}} from {app: {variant: "module:Class"}}."""
    return {app: {key: _lazy(_P + path.split(":")[0], path.split(":")[1])
                  for key, path in variants.items()}
            for app, variants in apps.items()}


def _with_two_tower(default, two_tower):
    return dict({"default": default}, **dict.fromkeys(_TWO_TOWER, two_tower))


DATASET_REGISTRY = _apps(
    text_classify={"default": "sequence_classification.data:"
                              "ClassificationDataset"},
    text_match=_with_two_tower("text_match.data:TextMatchDataset",
                               "text_match.data:TwoTowerDataset"),
    sequence_labeling={"default": "sequence_labeling.data:"
                                  "SequenceLabelingDataset"},
    vectorization={"default": "sequence_classification.data:"
                              "ClassificationDataset"},
    machine_reading_comprehension={
        "default": "machine_reading_comprehension.data:MRCDataset"},
    sequence_generation={"default": "sequence_generation.data:"
                                    "SequenceGenerationDataset"},
)
MODEL_REGISTRY = _apps(
    text_classify={"default": "sequence_classification.model:"
                              "SequenceClassification"},
    text_match=_with_two_tower("text_match.model:TextMatch",
                               "text_match.model:TextMatchTwoTower"),
    sequence_labeling={"default": "sequence_labeling.model:"
                                  "SequenceLabeling"},
    vectorization={"default": "feature_vectorization.model:"
                              "FeatureVectorization"},
    machine_reading_comprehension={
        "default": "machine_reading_comprehension.model:"
                   "MachineReadingComprehension"},
    sequence_generation={"default": "sequence_generation.model:"
                                    "SequenceGeneration"},
)
EVALUATOR_REGISTRY = _apps(
    text_classify={"default": "sequence_classification.evaluator:"
                              "SequenceClassificationEvaluator"},
    text_match=_with_two_tower("text_match.evaluator:TextMatchEvaluator",
                               "text_match.evaluator:"
                               "TextMatchTwoTowerEvaluator"),
    sequence_labeling={"default": "sequence_labeling.evaluator:"
                                  "SequenceLabelingEvaluator"},
    machine_reading_comprehension={
        "default": "machine_reading_comprehension.evaluator:MRCEvaluator"},
    sequence_generation={"default": "sequence_generation.evaluator:"
                                    "SequenceGenerationEvaluator"},
)
PREDICTOR_REGISTRY = _apps(
    text_classify={"default": "sequence_classification.predictor:"
                              "SequenceClassificationPredictor"},
    text_match=_with_two_tower("text_match.predictor:TextMatchPredictor",
                               "text_match.predictor:"
                               "TextMatchTwoTowerPredictor"),
    sequence_labeling={"default": "sequence_labeling.predictor:"
                                  "SequenceLabelingPredictor"},
    vectorization={"default": "feature_vectorization.predictor:"
                              "FeatureVectorizationPredictor"},
    machine_reading_comprehension={
        "default": "machine_reading_comprehension.predictor:MRCPredictor"},
    sequence_generation={"default": "sequence_generation.predictor:"
                                    "SequenceGenerationPredictor"},
)

_NOT_PORTED_MODES = {
    "export": "ROADMAP A26",
    "serve": "ROADMAP A17",
}
_ENCODER_DECODER = ("t5", "mt5", "bart", "pegasus", "randeng")
# the JAX package's variant switches, in its order (easynlp_tpu
# appzoo/api.py::_variant_key)
_VARIANT_KEYS = ("enable_metakd", "enable_distillation", "enable_fewshot",
                 "enable_kangaroo", "enable_dkplm", "enable_glm",
                 "multi_label", "two_tower", "siamese", "enable_vit",
                 "enable_vqgan", "contrast_learning_flag")
# user_defined_parameters switches whose app variant is not ported yet
_NOT_PORTED_VARIANTS = {
    "enable_metakd": "ROADMAP A12", "enable_distillation": "ROADMAP A12",
    "enable_fewshot": "ROADMAP A12", "enable_lora": "ROADMAP A12",
    "enable_kangaroo": "ROADMAP A13", "enable_dkplm": "ROADMAP A13",
    "contrast_learning_flag": "ROADMAP A13", "enable_glm": "ROADMAP A19",
    "multi_label": "ROADMAP A5", "enable_vit": "ROADMAP A21",
    "enable_vqgan": "ROADMAP A21", "enable_controlnet": "ROADMAP A22",
}


def _variant_key(registry_entry, udp):
    """The registry variant the user_defined_parameters switches select
    (the first switch set that the app has), else "default"."""
    for key in _VARIANT_KEYS:
        if udp.get(key) and key in registry_entry:
            return key
    return "default"


def _resolve(registry, app_name, udp):
    if app_name not in registry:
        raise NotImplementedError(
            "app %r is not ported yet (ROADMAP A9-A22), or has no entry in "
            "this registry (as in the JAX package); here the PyTorch port "
            "has: %s" % (app_name, sorted(registry)))
    for key, item in _NOT_PORTED_VARIANTS.items():
        if udp.get(key):
            raise NotImplementedError("%s=%s is not ported yet (%s)"
                                      % (key, udp[key], item))
    entry = registry[app_name]
    return entry[_variant_key(entry, udp)]()


def _check_generation_backbone(args):
    """sequence_generation trains and evaluates encoder-decoder backbones
    (BART) and predicts with GPT-2 and BART, in the port as far as it
    goes."""
    if args.app_name != "sequence_generation":
        return
    path = (args.pretrained_model_name_or_path if args.mode == "train"
            else args.predict_checkpoint_path or args.checkpoint_dir)
    if not path:
        return
    model_type = model_type_of(path) or "t5"
    seq2seq = model_type in _ENCODER_DECODER
    if args.mode == "train" and not seq2seq:
        raise NotImplementedError(
            "--mode=train --app_name=sequence_generation on a decoder-only "
            "checkpoint: the JAX package does not train GPT-2 through this "
            "app (its trainer passes decoder_input_ids, which its "
            "GPT2LMHeadModel does not take), so neither does the port")
    if args.mode == "evaluate" and not seq2seq:
        raise NotImplementedError(
            "--mode=evaluate --app_name=sequence_generation on a "
            "decoder-only checkpoint is not ported yet (ROADMAP A15b); the "
            "port evaluates encoder-decoder backbones")
    if args.mode == "predict" and seq2seq and model_type != "bart":
        raise NotImplementedError(
            "--mode=predict --app_name=sequence_generation on a %s "
            "checkpoint is not ported yet (ROADMAP A18c, A18d); the port "
            "predicts with GPT-2 and BART" % model_type)


def default_main_fn(args=None):
    args = args or get_args()
    udp = args.user_defined_parameters_dict
    _check_generation_backbone(args)
    if args.mode == "predict":
        return _predict_main(args, udp)
    if args.mode == "train":
        return _train_main(args, udp)
    if args.mode == "evaluate":
        return _evaluate_main(args, udp)
    if args.mode in _NOT_PORTED_MODES:
        raise NotImplementedError(
            "--mode=%s is not ported yet (%s); the PyTorch port has "
            "--mode=train|evaluate|predict"
            % (args.mode, _NOT_PORTED_MODES[args.mode]))
    raise ValueError("unknown mode %r" % args.mode)


def _dtype(args):
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def _dataset_kwargs(args, tokenizer):
    return dict(tokenizer=tokenizer, max_seq_length=args.sequence_length,
                input_schema=args.input_schema,
                first_sequence=args.first_sequence,
                second_sequence=args.second_sequence,
                label_name=args.label_name,
                label_enumerate_values=args.label_enumerate_values)


def _train_main(args, udp):
    """api.py's train branch: train (and valid) dataset, evaluator, the app
    from the pretrained directory, the Trainer."""
    from easynlp_tpu_torch.core.trainer import Trainer
    model_cls = _resolve(MODEL_REGISTRY, args.app_name, udp)
    dataset_cls = _resolve(DATASET_REGISTRY, args.app_name, udp)
    evaluator_cls = _resolve(EVALUATOR_REGISTRY, args.app_name, udp)
    if not args.pretrained_model_name_or_path:
        raise ValueError("--mode=train needs --pretrained_model_name_or_path "
                         "(or user_defined_parameters "
                         "pretrain_model_name_or_path)")
    tables = (args.tables or "").split(",")
    tokenizer = tokenizer_for(args.pretrained_model_name_or_path)
    kwargs = _dataset_kwargs(args, tokenizer)
    train_dataset = dataset_cls(data_file=tables[0], is_training=True,
                                **kwargs)
    if args.label_enumerate_values is None and \
            train_dataset.label_enumerate_values:
        kwargs["label_enumerate_values"] = train_dataset.label_enumerate_values
    evaluator = None
    if len(tables) > 1 and tables[1]:
        evaluator = evaluator_cls(dataset_cls(data_file=tables[1], **kwargs),
                                  args=args)
    app = model_cls.from_pretrained(
        args.pretrained_model_name_or_path, args=args, dtype=_dtype(args),
        device=args.device,
        num_labels=max(len(train_dataset.label_enumerate_values), 2),
        label_mapping=getattr(train_dataset, "label_mapping", None))
    trainer = Trainer(app, train_dataset, evaluator=evaluator, args=args,
                      tokenizer=tokenizer)
    trainer.train()
    return trainer


def _evaluate_main(args, udp):
    """api.py's evaluate branch: the checkpoint's app on --tables."""
    model_cls = _resolve(MODEL_REGISTRY, args.app_name, udp)
    dataset_cls = _resolve(DATASET_REGISTRY, args.app_name, udp)
    evaluator_cls = _resolve(EVALUATOR_REGISTRY, args.app_name, udp)
    tokenizer = tokenizer_for(args.checkpoint_dir)
    valid_dataset = dataset_cls(data_file=(args.tables or "").split(",")[0],
                                **_dataset_kwargs(args, tokenizer))
    app = model_cls.from_pretrained(
        args.checkpoint_dir, args=args, dtype=_dtype(args),
        device=args.device,
        num_labels=max(len(valid_dataset.label_enumerate_values), 2))
    results = evaluator_cls(valid_dataset, args=args).evaluate(app)
    for metric, score in results:
        logger.info("eval %s: %.6f", metric, score)
    return results


def _predict_main(args, udp):
    from easynlp_tpu_torch.core.predictor import PredictorManager
    dtype = _dtype(args)
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
        batch_size=args.micro_batch_size,
        user_defined_parameters=udp,
        multi_label=bool(udp.get("multi_label")))
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
