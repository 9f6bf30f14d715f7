"""GLM checkpoints for the PyTorch port: reference single-file checkpoints
and Megatron tensor-parallel slices.

Counterpart of easynlp_tpu/modelzoo/models/glm/conversion.py. The port's
GLMForConditionalGeneration keeps the reference's names, so a reference
`pytorch_model.bin` loads strictly after normalize_keys. A Megatron
checkpoint directory of `mp_rank_XX` slices merges on the host
(merge_megatron_tp_slices, the port's own copy of the JAX package's) into
one state dict that loads onto one card; state_dict_from_jax reads the
JAX app's parameter tree (flax_params.msgpack).
"""

import glob
import os

import numpy as np
import torch

_COLUMN_PARALLEL = ("attention.query_key_value", "mlp.dense_h_to_4h")
_ROW_PARALLEL = ("attention.dense", "mlp.dense_4h_to_h")
_VOCAB_PARALLEL = ("word_embeddings",)


def merge_megatron_tp_slices(slices):
    """[per-rank state dict] -> one full state dict (numpy values). Megatron
    mpu's layout: ColumnParallelLinear splits the output dim (concatenate
    rows), RowParallelLinear the input dim (concatenate the weight's
    columns), the vocab-parallel embedding its rows; the rest is
    replicated. Each rank holds its own stacked [q|k|v] block, so
    query_key_value merges per section and re-stacks q|k|v."""
    slices = [{k: np.asarray(v) for k, v in s.items()} for s in slices]
    if len(slices) == 1:
        return dict(slices[0])
    out = {}
    for key, first in slices[0].items():
        parts = [s[key] for s in slices]
        if "query_key_value" in key:
            sections = [np.split(p, 3, axis=0) for p in parts]
            out[key] = np.concatenate(
                [np.concatenate([sec[i] for sec in sections], axis=0)
                 for i in range(3)], axis=0)
        elif any(m in key for m in _COLUMN_PARALLEL + _VOCAB_PARALLEL):
            out[key] = np.concatenate(parts, axis=0)
        elif any(m in key for m in _ROW_PARALLEL) and key.endswith(".weight"):
            out[key] = np.concatenate(parts, axis=1)
        else:
            out[key] = first
    return out


def normalize_keys(state_dict):
    """A reference or Megatron GLM state dict under the port's names: the
    `module.`/`model.` wrappers dropped, everything under `glm.`, and all
    but `word_embeddings` under `glm.transformer.` (Megatron's mg_glm keys
    hold `transformer.` already, HF's `glm.transformer.`)."""
    out = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.startswith("glm."):
            k = k[len("glm."):]
        if not k.startswith(("word_embeddings.", "transformer.")):
            k = "transformer." + k
        out["glm." + k] = torch.as_tensor(np.asarray(v))
    return out


def load_megatron_glm_checkpoint(ckpt_dir):
    """A Megatron checkpoint directory (mp_rank_XX/model_optim_rng.pt or
    mp_rank_XX.pt slices) -> the merged state dict under the port's
    names."""
    files = sorted(glob.glob(os.path.join(ckpt_dir, "mp_rank_*", "*.pt"))
                   + glob.glob(os.path.join(ckpt_dir, "mp_rank_*.pt")))
    if not files:
        raise FileNotFoundError("no mp_rank_* slices under %s" % ckpt_dir)
    slices = []
    for path in files:
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.get("module", blob.get("model", blob)) \
            if isinstance(blob, dict) else blob
        slices.append({k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                       for k, v in sd.items() if hasattr(v, "shape")})
    return normalize_keys(merge_megatron_tp_slices(slices))


def state_dict_from_jax(params, config):
    """The port's GLMForConditionalGeneration state dict from the JAX
    app's tree ({"glm": GLMModel params, layers stacked [L, ...]}, numpy
    leaves): kernels [in, out] transposed to torch's [out, in]."""
    p = params.get("glm", params)
    out = {}

    def put(name, value):
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    put("glm.word_embeddings.weight", p["word_embeddings"]["embedding"])
    put("glm.transformer.position_embeddings.weight",
        p["position_embeddings"]["embedding"])
    if "block_position_embeddings" in p:
        put("glm.transformer.block_position_embeddings.weight",
            p["block_position_embeddings"]["embedding"])
    put("glm.transformer.final_layernorm.weight",
        p["final_layernorm"]["scale"])
    put("glm.transformer.final_layernorm.bias", p["final_layernorm"]["bias"])
    layers = p["layers"]
    names = {"input_layernorm": "input_layernorm",
             "post_attention_layernorm": "post_attention_layernorm",
             "qkv": "attention.query_key_value",
             "dense": "attention.dense",
             "dense_h_to_4h": "mlp.dense_h_to_4h",
             "dense_4h_to_h": "mlp.dense_4h_to_h"}
    for i in range(config.num_layers):
        base = "glm.transformer.layers.%d." % i
        for jax_name, name in names.items():
            leaf = layers[jax_name]
            if "kernel" in leaf:
                put(base + name + ".weight", np.asarray(leaf["kernel"][i]).T)
                put(base + name + ".bias", leaf["bias"][i])
            else:
                put(base + name + ".weight", leaf["scale"][i])
                put(base + name + ".bias", leaf["bias"][i])
    return out
