"""Checkpoint layouts for the port's CLIP.

Counterpart of easynlp_tpu/modelzoo/models/clip/conversion.py. The port's
CLIPModel keeps HF ChineseCLIPModel's names, so an HF Chinese-CLIP
`pytorch_model.bin` needs only `normalize_keys` (the nested
`vision_model.vision_model.` prefix of some exports, TF-style
gamma/beta, buffers HF derives). The OpenAI/Wukong dialect
(`visual.conv1`, `visual.class_embedding`, `visual.positional_embedding`,
`visual.ln_pre`, `visual.transformer.resblocks.{i}.{ln_1, attn.in_proj_*,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `visual.ln_post`,
`visual.proj` used as x @ proj, a `bert.*` text tower, `text_projection`
and `logit_scale`) maps onto the same names through `from_wukong`.
`state_dict_from_jax` reads the JAX CLIPModel's param tree (scanned [L,
...] layers, a fused qkv kernel, [in, out] kernels, the patch kernel in
(P, P, 3) rows).
"""

import numpy as np
import torch

from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    normalize_keys as normalize_bert_keys,
)
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    state_dict_from_jax as bert_state_dict_from_jax,
)

# buffers HF checkpoints may hold; the port derives them from shapes
_DERIVED = ("text_model.embeddings.position_ids",
            "text_model.embeddings.token_type_ids",
            "vision_model.embeddings.position_ids")
_VIT = "vision_model."


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def normalize_keys(state_dict):
    """An HF Chinese-CLIP state dict under the port's names."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("vision_model.vision_model."):
            k = k[len("vision_model."):]
        k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        if k in _DERIVED:
            continue
        out[k] = v.reshape(()) if k == "logit_scale" else v
    return out


def from_openai_visual(s, config, prefix="visual."):
    """The OpenAI-CLIP visual tower (also Wukong's and open_clip's) as the
    port's `vision_model.*` and `visual_projection.weight`."""
    e = config.vision_config.hidden_size
    out = {_VIT + "embeddings.patch_embedding.weight":
               s[prefix + "conv1.weight"],
           _VIT + "embeddings.class_embedding":
               s[prefix + "class_embedding"].reshape(-1),
           _VIT + "embeddings.position_embedding.weight":
               s[prefix + "positional_embedding"]}
    for ours, theirs in (("pre_layrnorm", "ln_pre"),
                         ("post_layernorm", "ln_post")):
        for p in ("weight", "bias"):
            out["%s%s.%s" % (_VIT, ours, p)] = s["%s%s.%s" % (prefix, theirs,
                                                              p)]
    for i in range(config.vision_config.num_hidden_layers):
        rb = "%stransformer.resblocks.%d." % (prefix, i)
        base = "%sencoder.layers.%d." % (_VIT, i)
        w, b = s[rb + "attn.in_proj_weight"], s[rb + "attn.in_proj_bias"]
        for j, name in enumerate("qkv"):
            rows = slice(j * e, (j + 1) * e)
            out[base + "self_attn.%s_proj.weight" % name] = w[rows]
            out[base + "self_attn.%s_proj.bias" % name] = b[rows]
        for ours, theirs in (("self_attn.out_proj", "attn.out_proj"),
                             ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                             ("mlp.fc1", "mlp.c_fc"),
                             ("mlp.fc2", "mlp.c_proj")):
            for p in ("weight", "bias"):
                out["%s%s.%s" % (base, ours, p)] = s["%s%s.%s" % (rb, theirs,
                                                                  p)]
    # visual.proj is applied as x @ proj: nn.Linear holds its transpose
    out["visual_projection.weight"] = s[prefix + "proj"].t()
    return out


def from_wukong(state_dict, config):
    """The Wukong dialect (`visual.*`, `bert.*`, `text_projection`,
    `logit_scale`) under the port's names. `text_projection` and
    `logit_scale` appear only where the checkpoint has them."""
    s = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = from_openai_visual(s, config)
    text = normalize_bert_keys({k: v for k, v in s.items()
                                if k.startswith(("bert.", "encoder.",
                                                 "embeddings."))})
    out.update({"text_model." + k: v for k, v in text.items()
                if not k.startswith("pooler.")
                and "text_model." + k not in _DERIVED})
    if "text_projection" in s:  # applied as x @ W
        out["text_projection.weight"] = s["text_projection"].t()
    elif "text_projection.weight" in s:
        out["text_projection.weight"] = s["text_projection.weight"]
    if "logit_scale" in s:
        out["logit_scale"] = s["logit_scale"].reshape(())
    return out


def vision_state_dict_from_jax(v, config):
    """A ViTEncoder state dict from the JAX ViTEncoder's params (numpy
    leaves); `config` is the vision config."""
    state = {}
    p = config.patch_size
    kernel = np.asarray(v["patch_embedding"]["kernel"])  # [P*P*3, E]
    state["embeddings.patch_embedding.weight"] = _t(
        kernel.reshape(p, p, 3, -1).transpose(3, 2, 0, 1))
    state["embeddings.class_embedding"] = _t(v["class_embedding"])
    state["embeddings.position_embedding.weight"] = _t(
        v["position_embedding"])
    for ours, theirs in (("pre_layrnorm", "pre_ln"),
                         ("post_layernorm", "post_ln")):
        state[ours + ".weight"] = _t(v[theirs]["scale"])
        state[ours + ".bias"] = _t(v[theirs]["bias"])
    layers = v["layers"]
    e = config.hidden_size
    for i in range(config.num_hidden_layers):
        base = "encoder.layers.%d." % i
        qkv_k = np.asarray(layers["qkv"]["kernel"][i])
        qkv_b = np.asarray(layers["qkv"]["bias"][i])
        for j, name in enumerate("qkv"):
            state[base + "self_attn.%s_proj.weight" % name] = _t(
                qkv_k[:, j * e:(j + 1) * e].T)
            state[base + "self_attn.%s_proj.bias" % name] = _t(
                qkv_b[j * e:(j + 1) * e])
        for ours, theirs in (("self_attn.out_proj", "proj"),
                             ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            state[base + ours + ".weight"] = _t(
                np.asarray(layers[theirs]["kernel"][i]).T)
            state[base + ours + ".bias"] = _t(layers[theirs]["bias"][i])
        for ours, theirs in (("layer_norm1", "ln_1"),
                             ("layer_norm2", "ln_2")):
            state[base + ours + ".weight"] = _t(layers[theirs]["scale"][i])
            state[base + ours + ".bias"] = _t(layers[theirs]["bias"][i])
    return state


def state_dict_from_jax(params, config):
    """The port's CLIPModel state dict from the JAX CLIPModel's params."""
    state = {"text_model." + k: v for k, v in bert_state_dict_from_jax(
        params["text_model"], config.text_config).items()}
    state.update({_VIT + k: v for k, v in vision_state_dict_from_jax(
        params["vision_model"], config.vision_config).items()})
    for name in ("text_projection", "visual_projection"):
        state[name + ".weight"] = _t(np.asarray(params[name]["kernel"]).T)
    state["logit_scale"] = _t(params["logit_scale"]).reshape(())
    return state


def load_clip_state_dict(module, state, optional=()):
    """`state` (the port's names) into a CLIPModel: strictly, but for the
    `optional` keys, which keep their init where the state lacks them."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state) - set(optional))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError("CLIP checkpoint: missing %s, unexpected %s"
                       % (missing[:8], unexpected[:8]))
    module.load_state_dict(state, strict=False)
