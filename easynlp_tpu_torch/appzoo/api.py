"""App dispatch + default main for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/api.py, reduced to what is ported: the
serve branch (both routes: the pipeline() PredictionServer, and with
serve_continuous=true continuous-batching GPT-2 generation), and the
train, evaluate and predict branches for the BERT apps `text_classify`
(and its multi_label variant), `text_match` (cross-encoder; two-tower with
user_defined_parameters two_tower or siamese), `sequence_labeling`,
`machine_reading_comprehension`, `information_extraction` and
`geep_classify`, train and evaluate for `language_modeling` (MLM
pretraining on BERT and RoBERTa; with user_defined_parameters
enable_dkplm, enable_kangaroo or contrast_learning_flag, DKPLM, Kangaroo
and CKBERT pretraining; with enable_glm, GLM block-infilling pretraining),
predict for `vectorization` and
`data_augmentation`, for `sequence_generation` train, evaluate and predict
on BART, T5, mT5, Pegasus and Randeng and evaluate and predict on GPT-2
(with enable_glm, GLM blank-infilling train, evaluate and predict), and
for `open_domain_dialogue` the same on the dialogue `transformer`, and
train, evaluate and predict for the multimodal apps `clip`,
`wukong_clip`, `text2video_retrieval`, `image2text_generation` (its ViT
variant, the default and enable_vit, and the VQGAN variant,
enable_vqgan), `video2text_generation` and `text2image_generation`
(ARTIST), and train, evaluate and predict for `latent_diffusion` (with
user_defined_parameters enable_controlnet, a ControlNet trained on the
frozen base; controlnet_hint names its hint, `edge`).
text_classify's variants take the
user_defined_parameters switches enable_distillation (vanilla KD against
saved teacher logits, with `temperature` and `alpha`), enable_metakd (the
meta-teacher, trained by MetaTeacherTrainer), enable_fewshot (PET) and,
for any app, enable_lora (adapters only: lora_rank, lora_alpha,
lora_targets). The registries map each app to its variants, as the JAX
package's do, and hold every app of the JAX package's. `--mode=export`
and the backbones still unported raise NotImplementedError naming their
ROADMAP items. The datasets are the port's
copies of the JAX package's, so both packages featurise and batch the same
rows the same way.
"""

import json
import os

import torch

from easynlp_tpu_torch.modelzoo.models.auto import model_type_of, tokenizer_for
from easynlp_tpu_torch.parallel.mesh import (
    data_parallel_rank,
    data_parallel_size,
)
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
    """{app: {variant: loader}} from {app: {variant: "module:Class"}}, the
    module under easynlp_tpu_torch.appzoo unless it starts with the
    package's name."""
    def load(path):
        module, name = path.split(":")
        if not module.startswith("easynlp_tpu_torch."):
            module = _P + module
        return _lazy(module, name)
    return {app: {key: load(path) for key, path in variants.items()}
            for app, variants in apps.items()}


def _with_two_tower(default, two_tower):
    return dict({"default": default}, **dict.fromkeys(_TWO_TOWER, two_tower))


_KD = "easynlp_tpu_torch.distillation."
_FEWSHOT = "easynlp_tpu_torch.fewshot_learning."

DATASET_REGISTRY = _apps(
    text_classify={
        "default": "sequence_classification.data:ClassificationDataset",
        "enable_distillation": _KD + "distill_dataset:"
                                     "DistillatoryClassificationDataset",
        "enable_fewshot": _FEWSHOT + "fewshot_dataset:FewshotDataset",
        "enable_metakd": _KD + "distill_metakd_dataset:"
                               "MetaKDClassificationDataset"},
    text_match=_with_two_tower("text_match.data:TextMatchDataset",
                               "text_match.data:TwoTowerDataset"),
    sequence_labeling={"default": "sequence_labeling.data:"
                                  "SequenceLabelingDataset"},
    vectorization={"default": "sequence_classification.data:"
                              "ClassificationDataset"},
    machine_reading_comprehension={
        "default": "machine_reading_comprehension.data:MRCDataset"},
    sequence_generation={
        "default": "sequence_generation.data:SequenceGenerationDataset",
        "enable_glm": "sequence_generation.glm:"
                      "GLMSequenceGenerationDataset"},
    open_domain_dialogue={"default": "sequence_generation.data:"
                                     "SequenceGenerationDataset"},
    language_modeling={
        "default": "language_modeling.data:LanguageModelingDataset",
        "enable_kangaroo": "language_modeling.kangaroo_data:"
                           "KangarooPretrainDataset",
        "enable_dkplm": "language_modeling.dkplm_data:"
                        "DKPLMPretrainDataset",
        "enable_glm": "language_modeling.glm_pretrain:GLMPretrainDataset"},
    data_augmentation={"default": "language_modeling.data:"
                                  "LanguageModelingDataset"},
    information_extraction={"default": "information_extraction.data:"
                                       "InformationExtractionDataset"},
    geep_classify={"default": "sequence_classification.data:"
                              "ClassificationDataset"},
    clip={"default": "clip.data:CLIPDataset"},
    wukong_clip={"default": "wukong_clip.data:WukongCLIPDataset"},
    text2video_retrieval={"default": "text2video_retrieval.data:"
                                     "Text2VideoRetrievalDataset"},
    image2text_generation={
        "default": "image2text_generation.data:ImageTextDataset",
        "enable_vit": "image2text_generation.data:ImageTextDataset",
        "enable_vqgan": "image2text_generation.vqgan_model:"
                        "VQGANImageTextDataset"},
    video2text_generation={"default": "video2text_generation.data:FrameTextDataset"},
    text2image_generation={"default": "text2image_generation.data:"
                                      "TextImageDataset"},
    latent_diffusion={"default": "latent_diffusion.data:LDMDataset"},
)
MODEL_REGISTRY = _apps(
    text_classify={
        "default": "sequence_classification.model:SequenceClassification",
        "multi_label": "sequence_classification.model:"
                       "SequenceMultiLabelClassification",
        "enable_distillation": _KD + "distill_application:"
                                     "DistillatorySequenceClassification",
        "enable_fewshot": _FEWSHOT + "fewshot_application:"
                                     "FewshotClassification",
        "enable_metakd": _KD + "distill_metakd_application:"
                               "MetaTeacherClassification"},
    text_match=_with_two_tower("text_match.model:TextMatch",
                               "text_match.model:TextMatchTwoTower"),
    sequence_labeling={"default": "sequence_labeling.model:"
                                  "SequenceLabeling"},
    vectorization={"default": "feature_vectorization.model:"
                              "FeatureVectorization"},
    machine_reading_comprehension={
        "default": "machine_reading_comprehension.model:"
                   "MachineReadingComprehension"},
    sequence_generation={
        "default": "sequence_generation.model:SequenceGeneration",
        "enable_glm": "sequence_generation.glm:GLMSequenceGeneration"},
    open_domain_dialogue={"default": "open_domain_dialogue.model:"
                                     "OpenDomainDialogue"},
    language_modeling={
        "default": "language_modeling.model:LanguageModeling",
        "contrast_learning_flag": "language_modeling.model:"
                                  "CKBertLanguageModeling",
        "enable_kangaroo": "language_modeling.model:"
                           "KangarooLanguageModeling",
        "enable_dkplm": "language_modeling.model:DKPLMLanguageModeling",
        "enable_glm": "sequence_generation.glm:GLMSequenceGeneration"},
    data_augmentation={"default": "language_modeling.model:"
                                  "LanguageModeling"},
    information_extraction={"default": "information_extraction.model:"
                                       "InformationExtractionModel"},
    geep_classify={"default": "geep_classification.model:"
                              "GEEPClassification"},
    clip={"default": "clip.model:CLIPApp"},
    wukong_clip={"default": "wukong_clip.model:WukongCLIP"},
    text2video_retrieval={"default": "text2video_retrieval.model:"
                                     "Text2VideoRetrieval"},
    image2text_generation={
        "default": "image2text_generation.model:CLIPGPTImageTextGeneration",
        "enable_vit": "image2text_generation.model:CLIPGPTImageTextGeneration",
        "enable_vqgan": "image2text_generation.vqgan_model:"
                        "VQGANGPTImageTextGeneration"},
    video2text_generation={"default": "video2text_generation.model:CLIPGPTFrameTextGeneration"},
    text2image_generation={"default": "text2image_generation.model:"
                                      "TextImageGeneration"},
    latent_diffusion={"default": "latent_diffusion.model:LatentDiffusion"},
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
    open_domain_dialogue={"default": "sequence_generation.evaluator:"
                                     "SequenceGenerationEvaluator"},
    language_modeling={
        "default": "language_modeling.evaluator:LanguageModelingEvaluator",
        "enable_glm": "language_modeling.glm_pretrain:"
                      "GLMPretrainEvaluator"},
    information_extraction={"default": "information_extraction.evaluator:"
                                       "InformationExtractionEvaluator"},
    geep_classify={"default": "sequence_classification.evaluator:"
                              "SequenceClassificationEvaluator"},
    clip={"default": "clip.evaluator:CLIPEvaluator"},
    wukong_clip={"default": "wukong_clip.evaluator:WukongCLIPEvaluator"},
    text2video_retrieval={"default": "text2video_retrieval.evaluator:"
                                     "Text2VideoRetrievalEvaluator"},
    image2text_generation={
        "default": "image2text_generation.evaluator:ImageTextGenerationEvaluator",
        "enable_vit": "image2text_generation.evaluator:ImageTextGenerationEvaluator"},
    video2text_generation={"default": "video2text_generation.evaluator:FrameTextGenerationEvaluator"},
    text2image_generation={"default": "text2image_generation.evaluator:"
                                      "TextImageGenerationEvaluator"},
    latent_diffusion={"default": "latent_diffusion.evaluator:LDMEvaluator"},
)
PREDICTOR_REGISTRY = _apps(
    text_classify={
        "default": "sequence_classification.predictor:"
                   "SequenceClassificationPredictor",
        "enable_fewshot": _FEWSHOT + "fewshot_predictor:FewshotPredictor"},
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
    open_domain_dialogue={"default": "sequence_generation.predictor:"
                                     "SequenceGenerationPredictor"},
    data_augmentation={"default": "data_augmentation.predictor:"
                                  "DataAugmentationPredictor"},
    information_extraction={"default": "information_extraction.predictor:"
                                       "InformationExtractionPredictor"},
    geep_classify={"default": "sequence_classification.predictor:"
                              "SequenceClassificationPredictor"},
    clip={"default": "clip.predictor:CLIPPredictor"},
    wukong_clip={"default": "wukong_clip.predictor:WukongCLIPPredictor"},
    text2video_retrieval={"default": "text2video_retrieval.predictor:"
                                     "Text2VideoRetrievalPredictor"},
    image2text_generation={
        "default": "image2text_generation.predictor:ImageTextGenerationPredictor",
        "enable_vit": "image2text_generation.predictor:ImageTextGenerationPredictor"},
    video2text_generation={"default": "video2text_generation.predictor:FrameTextGenerationPredictor"},
    text2image_generation={"default": "text2image_generation.predictor:"
                                      "TextImageGenerationPredictor"},
    latent_diffusion={"default": "latent_diffusion.predictor:LDMPredictor"},
)

_NOT_PORTED_MODES = {
    "export": "ROADMAP A26",
}
# the JAX package's variant switches, in its order (easynlp_tpu
# appzoo/api.py::_variant_key)
_VARIANT_KEYS = ("enable_metakd", "enable_distillation", "enable_fewshot",
                 "enable_kangaroo", "enable_dkplm", "enable_glm",
                 "multi_label", "two_tower", "siamese", "enable_vit",
                 "enable_vqgan", "contrast_learning_flag")


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
            "app %r has no entry in this registry, as in the JAX package; "
            "the PyTorch port's has: %s" % (app_name, sorted(registry)))
    entry = registry[app_name]
    return entry[_variant_key(entry, udp)]()


def _check_generation_backbone(args):
    """sequence_generation and open_domain_dialogue train encoder-decoder
    backbones; GPT-2 checkpoints evaluate and predict only."""
    if args.app_name not in ("sequence_generation", "open_domain_dialogue") \
            or args.mode != "train":
        return
    path = args.pretrained_model_name_or_path
    if path and model_type_of(path) == "gpt2":
        raise NotImplementedError(
            "--mode=train --app_name=%s on a decoder-only checkpoint: the "
            "JAX package does not train GPT-2 through this app (its trainer "
            "passes decoder_input_ids, which its GPT2LMHeadModel does not "
            "take), so neither does the port" % args.app_name)


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
    if args.mode == "serve":
        return _serve_main(args, udp)
    if args.mode in _NOT_PORTED_MODES:
        raise NotImplementedError(
            "--mode=%s is not ported yet (%s); the PyTorch port has "
            "--mode=train|evaluate|predict|serve"
            % (args.mode, _NOT_PORTED_MODES[args.mode]))
    raise ValueError("unknown mode %r" % args.mode)


def _dtype(args):
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


# the apps whose datasets read images: they also take the JAX api's
# image_size, image_cache and image_cache_items
_IMAGE_APPS = ("clip", "wukong_clip", "text2video_retrieval",
               "image2text_generation", "video2text_generation",
               "latent_diffusion")


def _dataset_kwargs(args, tokenizer):
    udp = args.user_defined_parameters_dict
    kwargs = dict(tokenizer=tokenizer, max_seq_length=args.sequence_length,
                  input_schema=args.input_schema,
                  first_sequence=args.first_sequence,
                  second_sequence=args.second_sequence,
                  label_name=args.label_name,
                  label_enumerate_values=args.label_enumerate_values,
                  multi_label=_multi_label(args),
                  user_defined_parameters=udp)
    if args.app_name in _IMAGE_APPS:
        kwargs.update(image_size=int(udp.get("image_size", 224)),
                      image_cache=udp.get("image_cache"),
                      image_cache_items=udp.get("image_cache_items"))
    return kwargs


def _multi_label(args):
    return bool(args.user_defined_parameters_dict.get("multi_label"))


def _check_dataset(app, dataset):
    """The app's check of the dataset's knowledge widths against its
    config (the language_modeling knowledge variants), before any step."""
    check = getattr(app, "check_dataset", None)
    if check is not None:
        check(dataset)


def _train_main(args, udp):
    """api.py's train branch: train (and valid) dataset, evaluator, the app
    from the pretrained directory (KD configured from the parameters, or
    wrapped for LoRA), the Trainer (MetaTeacherTrainer for enable_metakd,
    DistillatoryTrainer for enable_distillation)."""
    from easynlp_tpu_torch.core import distiller
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
    # each data-parallel rank reads its rows (JAX api.py:594-595); ranks
    # of one data group (tensor, sequence) read the same ones
    train_dataset = dataset_cls(data_file=tables[0], is_training=True,
                                process_index=data_parallel_rank(),
                                num_processes=data_parallel_size(), **kwargs)
    if args.label_enumerate_values is None and \
            train_dataset.label_enumerate_values:
        kwargs["label_enumerate_values"] = train_dataset.label_enumerate_values
    evaluator = None
    if len(tables) > 1 and tables[1]:
        evaluator = evaluator_cls(dataset_cls(data_file=tables[1], **kwargs),
                                  args=args, multi_label=_multi_label(args))
    app = model_cls.from_pretrained(
        args.pretrained_model_name_or_path, args=args, dtype=_dtype(args),
        device=args.device,
        num_labels=max(len(train_dataset.label_enumerate_values), 2),
        label_mapping=getattr(train_dataset, "label_mapping", None))
    _check_dataset(app, train_dataset)
    if hasattr(app, "configure"):
        # KD's temperature and alpha (the JAX api never calls its
        # configure: ROADMAP reference fault 20)
        app.configure(udp)
    if udp.get("enable_controlnet"):
        # train a ControlNet on the frozen base (the JAX api's wrapper)
        from easynlp_tpu_torch.appzoo.latent_diffusion.controlnet_app import (
            ControlNetApplication)
        app = ControlNetApplication(
            app, hint_type=udp.get("controlnet_hint", "edge"))
    elif udp.get("enable_lora"):
        from easynlp_tpu_torch.core.lora_app import LoRAApplication
        from easynlp_tpu_torch.modelzoo.lora import parse_targets
        app = LoRAApplication(
            app, rank=int(udp.get("lora_rank", 4)),
            alpha=float(udp["lora_alpha"]) if udp.get("lora_alpha")
            else None,
            targets=parse_targets(udp.get("lora_targets")))
    trainer_cls, trainer_kwargs = Trainer, {}
    if udp.get("enable_metakd"):
        trainer_cls = distiller.MetaTeacherTrainer
        trainer_kwargs = {"user_defined_parameters": udp}
    elif udp.get("enable_distillation"):
        trainer_cls = distiller.DistillatoryTrainer
    trainer = trainer_cls(app, train_dataset, evaluator=evaluator, args=args,
                          tokenizer=tokenizer, **trainer_kwargs)
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
    _check_dataset(app, valid_dataset)
    results = evaluator_cls(valid_dataset, args=args,
                            multi_label=_multi_label(args)).evaluate(app)
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
        multi_label=_multi_label(args))
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


def _serve_main(args, udp):
    """--mode=serve: HTTP online serving (easynlp_tpu_torch/serving). The
    default route serves the pipeline() view of --checkpoint_dir with
    dynamic micro-batching (udp keys serve_host, serve_port,
    serve_max_delay_ms, serve_blocking, serve_quantize, serve_params_dtype);
    serve_continuous=true serves GPT-2 generation (_serve_continuous_main).
    serve_quantize=int8 serves weight-only int8 weights on both routes."""
    if str(udp.get("serve_continuous", "")).lower() in ("1", "true"):
        return _serve_continuous_main(args, udp)
    from easynlp_tpu_torch.serving import serve
    return serve(
        args.checkpoint_dir,
        host=udp.get("serve_host", "127.0.0.1"),
        port=int(udp.get("serve_port", 8080)),
        max_batch_size=args.micro_batch_size,
        max_delay_ms=float(udp.get("serve_max_delay_ms", 5.0)),
        blocking=str(udp.get("serve_blocking", "True")) != "False",
        first_sequence=args.first_sequence or "first_sequence",
        second_sequence=args.second_sequence,
        sequence_length=args.sequence_length,
        batch_size=args.micro_batch_size,
        dtype=_dtype(args),
        quantize=udp.get("serve_quantize") or None,
        params_dtype=udp.get("serve_params_dtype") or None,
        device=args.device)


def _serve_continuous_main(args, udp):
    """--mode=serve + serve_continuous=true: continuous-batching generation
    serving for a GPT-2 checkpoint (the JAX package's
    _serve_continuous_main). The model loads through the
    sequence_generation app, a ContinuousBatcher steps it (requests join and
    leave the shared decode loop mid-flight), and GenerationServer exposes
    POST /generate with per-request sampling parameters and streaming.

    udp keys: serve_host/serve_port/serve_blocking (shared with the
    pipeline server), serve_slots (decode batch width, default 8),
    serve_chunk_size (decode steps per dispatch, default 16),
    serve_prompt_buckets (comma-separated prefill widths, default
    sequence_length//4), serve_max_new_tokens (default 32),
    serve_eos_token_id / serve_pad_token_id (default: the tokenizer's),
    serve_params_dtype (default bfloat16 under --dtype=bfloat16; float32
    keeps the checkpoint's weights), serve_quantize=int8 (weight-only
    int8, dequantized in each forward; the other weights are then cast as
    serve_params_dtype says), serve_shared_prefix (system-prompt
    text, tokenized once; requests then send only suffixes) or
    serve_shared_prefix_ids (comma-separated token ids). The KV window is
    --sequence_length."""
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.modeling_utils import (
        available_checkpoint)
    from easynlp_tpu_torch.serving import ContinuousBatcher, GenerationServer
    ckpt = args.checkpoint_dir
    if model_type_of(ckpt) != "gpt2":
        raise ValueError(
            "serve_continuous=true serves decoder-only (gpt2) checkpoints; "
            "%r has model_type %r" % (ckpt, model_type_of(ckpt)))
    if available_checkpoint(ckpt) != "pytorch":
        raise ValueError("no loadable checkpoint (pytorch_model.bin) in %r"
                         % ckpt)
    app = SequenceGeneration.from_pretrained(ckpt, args=args,
                                             dtype=_dtype(args),
                                             device=args.device)
    quantize = str(udp.get("serve_quantize", "")).strip()
    if quantize:
        if quantize != "int8":
            raise ValueError("serve_quantize must be int8 (got %r)"
                             % quantize)
        from easynlp_tpu_torch.modelzoo.quantization import quantize_params
        quantize_params(app.module)
    # generation serving streams the weights every step: cast the stored
    # f32 kernels to bf16 by default under bf16, as the JAX package does
    pd = str(udp.get("serve_params_dtype",
                     "bfloat16" if args.dtype == "bfloat16" else "")).strip()
    if pd in ("bfloat16", "bf16"):
        from easynlp_tpu_torch.modelzoo.quantization import cast_params
        cast_params(app.module, torch.bfloat16)
    tokenizer = tokenizer_for(ckpt)
    max_length = int(args.sequence_length)
    raw = udp.get("serve_prompt_buckets")
    if raw:
        buckets = tuple(sorted(int(b) for b in str(raw).split(",")))
    else:
        buckets = (max(8, max_length // 4),)
    if buckets[-1] >= max_length:
        raise ValueError(
            "largest prompt bucket %d must stay below the KV window "
            "(--sequence_length=%d) to leave room for generation"
            % (buckets[-1], max_length))
    eos = udp.get("serve_eos_token_id",
                  getattr(tokenizer, "eos_token_id", None))
    pad = udp.get("serve_pad_token_id",
                  getattr(tokenizer, "pad_token_id", None))
    prefix = None
    if udp.get("serve_shared_prefix_ids"):
        prefix = [int(x) for x in
                  str(udp["serve_shared_prefix_ids"]).split(",")]
    elif udp.get("serve_shared_prefix"):
        prefix = list(tokenizer.convert_tokens_to_ids(
            tokenizer.tokenize(str(udp["serve_shared_prefix"]))))
    if prefix and len(prefix) + buckets[-1] >= max_length:
        raise ValueError(
            "shared prefix (%d tokens) + largest prompt bucket %d must "
            "stay below the KV window (--sequence_length=%d)"
            % (len(prefix), buckets[-1], max_length))
    batcher = ContinuousBatcher(
        app.module,
        max_slots=int(udp.get("serve_slots", 8)),
        max_length=max_length,
        prompt_buckets=buckets,
        eos_token_id=None if eos is None else int(eos),
        pad_token_id=0 if pad is None else int(pad),
        chunk_size=int(udp.get("serve_chunk_size", 16)),
        shared_prefix=prefix)
    server = GenerationServer(
        batcher,
        host=udp.get("serve_host", "127.0.0.1"),
        port=int(udp.get("serve_port", 8080)),
        tokenizer=tokenizer,
        default_max_new_tokens=int(udp.get("serve_max_new_tokens", 32)),
        info={"model": str(ckpt), "mode": "continuous"})
    if str(udp.get("serve_blocking", "True")) != "False":
        server.serve_forever()
    else:
        server.start()
    return server
