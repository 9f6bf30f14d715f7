"""pipeline() inference factory for the PyTorch port.

Counterpart of easynlp_tpu/pipelines/__init__.py, reduced to the tasks the
port runs: text_classify, text_match, sequence_labeling, vectorization,
data_augmentation, machine_reading_comprehension, image2text_generation,
text2image_generation (ARTIST: prompts to base64 PNGs),
sequence_generation, open_domain_dialogue and the PAI-Diffusion family
(latent_diffusion, chinese-ldm-*, stable-diffusion-general: prompts to
images through StableDiffusionPipeline). pipeline(model_dir)
infers the task from the directory's train_config.json, and
pipeline(task, model_path=dir) names it. A task name without model_path
(its default model) and a registered model name resolve through the app
zoo registry (utils/zoo_registry.py, as JAX pipelines/__init__.py:91-126).
"""

import json
import os

from easynlp_tpu_torch.pipelines.implementation import Pipeline  # noqa: F401
from easynlp_tpu_torch.utils import get_pretrain_model_path
from easynlp_tpu_torch.utils.io_utils import io

# "default": the registered app-model name pipeline(task) resolves (the
# JAX package's defaults)
SUPPORTED_TASKS = {
    "text_classify": {"app": "text_classify", "default": "bert-base-sst"},
    "text_match": {"app": "text_match", "default": "bert-small-qnli"},
    "sequence_labeling": {"app": "sequence_labeling",
                          "default": "chinese-roberta-basener"},
    "vectorization": {"app": "vectorization"},
    "machine_reading_comprehension": {
        "app": "machine_reading_comprehension",
        "default": "macbert-base-rczh"},
    "sequence_generation": {"app": "sequence_generation"},
    "open_domain_dialogue": {"app": "open_domain_dialogue"},
    "data_augmentation": {"app": "data_augmentation"},
    "image2text_generation": {"app": "image2text_generation",
                              "default": "clip-gpt-i2t-base-zh"},
    "text2image_generation": {"app": "text2image_generation",
                              "default": "artist-base-zh"},
}
# the PAI-Diffusion family: prompt -> image
for _ldm_task in ("latent_diffusion", "chinese-ldm-general",
                  "chinese-ldm-fashion", "chinese-ldm-art",
                  "chinese-ldm-poem", "chinese-ldm-anime", "chinese-ldm-pet",
                  "chinese-ldm-food", "stable-diffusion-general"):
    SUPPORTED_TASKS[_ldm_task] = {"app": "latent_diffusion",
                                  "diffusion": True}

def pipeline(task_or_model_path, model_path=None, **kwargs):
    """pipeline('text_classify') resolves the task's default model through
    the app zoo registry; pipeline('<registered-model-name>') resolves that
    model and its app; pipeline(model_dir) infers the task from the saved
    train_config.json; pipeline(task, model_path=dir) names it. kwargs go
    to Pipeline (device="cpu" to run on the CPU)."""
    from easynlp_tpu_torch.utils.zoo_registry import (
        get_app_model_path, get_remote_app_model_mapping)
    if task_or_model_path in SUPPORTED_TASKS:
        task = task_or_model_path
        if model_path is None:
            default = SUPPORTED_TASKS[task].get("default")
            if default is None:
                # the PAI-Diffusion names are task and model names both:
                # the registry is tried under the task's own name
                try:
                    model_path = get_app_model_path(task)
                except RuntimeError:
                    raise ValueError(
                        "pipeline(%r) needs model_path= (no default model "
                        "registered for this task)" % task) from None
            else:
                model_path = get_app_model_path(default)
        return Pipeline(task, get_pretrain_model_path(model_path), **kwargs)
    try:
        mapping = get_remote_app_model_mapping()
    except RuntimeError:
        mapping = {}
    if task_or_model_path in mapping:
        task = mapping[task_or_model_path]["app_name"]
        if task not in SUPPORTED_TASKS:
            raise KeyError("task %r not in SUPPORTED_TASKS" % task)
        return Pipeline(task, get_app_model_path(task_or_model_path, mapping),
                        **kwargs)
    model_path = get_pretrain_model_path(task_or_model_path)
    cfg = os.path.join(model_path, "train_config.json")
    if not io.exists(cfg):
        raise ValueError(
            "cannot infer task: %s has no train_config.json" % model_path)
    with io.open(cfg) as f:
        task = json.load(f).get("app_name")
    if task not in SUPPORTED_TASKS:
        raise KeyError("task %r not in SUPPORTED_TASKS" % task)
    return Pipeline(task, model_path, **kwargs)
