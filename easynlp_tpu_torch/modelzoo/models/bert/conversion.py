"""Checkpoint keys and layouts for the port's BERT.

The port's modules carry the HF names, so a reference/HF `pytorch_model.bin`
needs only key normalisation (the same rules as
easynlp_tpu/modelzoo/models/bert/conversion.py::_norm_keys: a leading
`bert.` prefix stripped, TF-style `gamma`/`beta` LayerNorm names renamed).
`state_dict_from_jax` goes the other way from the JAX package's own layout
(scanned layers, fused QKV, [in,out] kernels) into the port's state dict.

Masked-LM checkpoints (BertForMaskedLM) keep the HF names of their model
type: `bert.*` with `cls.predictions.{transform.dense,
transform.LayerNorm, bias}`, or `roberta.*` with `lm_head.{dense,
layer_norm, bias}`; the decoder is tied to the word embeddings, so its
`*.decoder.*` keys are neither read nor written.
"""

import numpy as np
import torch

BACKBONE_PREFIXES = ("embeddings.", "encoder.", "pooler.")
# buffers some HF checkpoints save; the port derives them from shapes
_DERIVED = ("embeddings.position_ids", "embeddings.token_type_ids")


def normalize_keys(state_dict):
    """Strip a leading 'bert.' prefix and rename gamma/beta."""
    out = {}
    for k, v in state_dict.items():
        k = k[5:] if k.startswith("bert.") else k
        out[k.replace(".gamma", ".weight").replace(".beta", ".bias")] = v
    return out


def split_backbone(state_dict, pooler=True):
    """(backbone state dict, other keys) of a normalised state dict. The
    backbone part loads into BertModel with strict=True; the other keys
    (task heads such as `classifier.*` or `cls.*`) are left to the caller.
    pooler=False drops `pooler.*`, for a BertModel built without one (the
    JAX apps' conversions pop it likewise)."""
    backbone, other = {}, {}
    for k, v in state_dict.items():
        if k in _DERIVED or (not pooler and k.startswith("pooler.")):
            continue
        (backbone if k.startswith(BACKBONE_PREFIXES) else other)[k] = v
    return backbone, other


def load_app_state_dict(module, state_dict, heads=()):
    """Load a reference/HF checkpoint into an app module that holds a
    `backbone` BertModel and the linear `heads` (names such as
    `classifier`): the backbone strictly after key normalisation, each head
    strictly when the checkpoint has it (a pretrained backbone leaves the
    head at its init). Keys that nothing takes are logged."""
    from easynlp_tpu_torch.utils.logger import logger
    backbone, other = split_backbone(
        normalize_keys(state_dict), pooler=module.backbone.pooler is not None)
    module.backbone.load_state_dict(backbone, strict=True)
    used = set()
    for name in heads:
        head = {k[len(name) + 1:]: v for k, v in other.items()
                if k.startswith(name + ".")}
        if head:
            getattr(module, name).load_state_dict(head, strict=True)
            used.update(name + "." + k for k in head)
        else:
            logger.info("%s initialised from scratch (not in checkpoint)",
                        name)
    unused = sorted(set(other) - used)
    if unused:
        logger.info("checkpoint params unused by model: %s",
                    unused[:12] + (["..."] if len(unused) > 12 else []))


def export_app_state_dict(module, heads=()):
    """An app module's weights under the reference/HF names: `bert.*` for
    the backbone, `<head>.*` for each head."""
    out = {"bert." + k: v for k, v in module.backbone.state_dict().items()}
    for name in heads:
        out.update({name + "." + k: v
                    for k, v in getattr(module, name).state_dict().items()})
    return out


def app_state_dict_from_jax(params, config, heads=()):
    """An app module's state dict from the JAX app's param tree (numpy
    leaves): `backbone.*` through state_dict_from_jax, and each head's
    [in, out] kernel transposed to torch's [out, in] weight."""
    state = {"backbone." + k: v
             for k, v in state_dict_from_jax(params["backbone"],
                                             config).items()}
    for name in heads:
        state[name + ".weight"] = torch.tensor(np.asarray(
            params[name]["kernel"], dtype=np.float32).T)
        state[name + ".bias"] = torch.tensor(np.asarray(
            params[name]["bias"], dtype=np.float32))
    return state


def state_dict_from_jax(params, config):
    """The port's BertModel state dict from a JAX BertModel param tree with
    numpy leaves: unstacks the [L, ...] scanned layers, splits the fused
    [E, 3E] qkv kernel into q|k|v columns and transposes [in,out] kernels to
    torch's [out,in]. A pre-LN tree (a `final_ln` beside the layers, no
    embedding LayerNorm) maps onto the pre-LN names: attention_ln to
    `attention.ln`, output_ln to `ln`, final_ln to `encoder.ln` (the
    inverse of the JAX package's convert_megatron_bert)."""
    state = {}

    def put(key, arr):
        state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))

    def put_dense(key, p, i=None):
        kernel, bias = p["kernel"], p["bias"]
        if i is not None:
            kernel, bias = kernel[i], bias[i]
        put(key + ".weight", np.asarray(kernel).T)
        put(key + ".bias", bias)

    def put_ln(key, p, i):
        put(key + ".weight", p["scale"][i] if i is not None else p["scale"])
        put(key + ".bias", p["bias"][i] if i is not None else p["bias"])

    emb = params["embeddings"]
    put("embeddings.word_embeddings.weight",
        emb["word_embeddings"]["embedding"])
    put("embeddings.position_embeddings.weight",
        emb["position_embeddings"]["embedding"])
    if "token_type_embeddings" in emb:
        put("embeddings.token_type_embeddings.weight",
            emb["token_type_embeddings"]["embedding"])
    if "LayerNorm" in emb:
        put_ln("embeddings.LayerNorm", emb["LayerNorm"], None)

    layers = params["encoder"]["layers"]
    pre_ln = "final_ln" in params["encoder"]
    ln_names = (("attention.ln", "ln") if pre_ln else
                ("attention.output.LayerNorm", "output.LayerNorm"))
    e = config.hidden_size
    for i in range(config.num_hidden_layers):
        base = "encoder.layer.%d." % i
        qkv_kernel = np.asarray(layers["attention"]["qkv"]["kernel"][i])
        qkv_bias = np.asarray(layers["attention"]["qkv"]["bias"][i])
        for j, name in enumerate(("query", "key", "value")):
            put(base + "attention.self.%s.weight" % name,
                qkv_kernel[:, j * e:(j + 1) * e].T)
            put(base + "attention.self.%s.bias" % name,
                qkv_bias[j * e:(j + 1) * e])
        put_dense(base + "attention.output.dense",
                  layers["attention"]["output"], i)
        put_ln(base + ln_names[0], layers["attention_ln"], i)
        put_dense(base + "intermediate.dense", layers["intermediate"], i)
        put_dense(base + "output.dense", layers["output"], i)
        put_ln(base + ln_names[1], layers["output_ln"], i)
    if pre_ln:
        put_ln("encoder.ln", params["encoder"]["final_ln"], None)
    if "pooler" in params:
        put_dense("pooler.dense", params["pooler"]["dense"])
    return state


# HF names of the MLM head by model type: (backbone prefix, {HF prefix: the
# port's BertMLMHead prefix})
MLM_NAMES = {
    "bert": ("bert.", {"cls.predictions.transform.dense.": "dense.",
                       "cls.predictions.transform.LayerNorm.": "LayerNorm.",
                       "cls.predictions.bias": "bias"}),
    "roberta": ("roberta.", {"lm_head.dense.": "dense.",
                             "lm_head.layer_norm.": "LayerNorm.",
                             "lm_head.bias": "bias"}),
}
_TIED_DECODER = ("cls.predictions.decoder.", "lm_head.decoder.")


def _mlm_names(config):
    return MLM_NAMES["roberta" if config.model_type == "roberta" else "bert"]


def load_mlm_state_dict(module, state_dict, optional=()):
    """An HF/reference masked-LM checkpoint into a BertForMaskedLM, by the
    names of its config's model type: the backbone strictly (with or
    without its prefix, gamma/beta renamed, pooler dropped), the head
    strictly when the checkpoint has it (a bare backbone leaves the head at
    its init). `optional`: prefixes of backbone parameters beyond BERT's
    (DKPLM's `know_linear.`), loaded where the checkpoint has them and
    left at their init where it has not (a BERT checkpoint). Keys that
    nothing takes are logged."""
    from easynlp_tpu_torch.utils.logger import logger
    prefix, head_names = _mlm_names(module.config)
    state = {}
    for k, v in state_dict.items():
        k = k[len(prefix):] if k.startswith(prefix) else k
        state[k.replace(".gamma", ".weight").replace(".beta", ".bias")] = v
    backbone, other = split_backbone(state, pooler=False)
    own = module.bert.state_dict()
    for extra in optional:
        found = {k: other.pop(k) for k in list(other) if k.startswith(extra)}
        if not found:
            logger.info("%s initialised from scratch (not in checkpoint)",
                        extra.rstrip("."))
            found = {k: v for k, v in own.items() if k.startswith(extra)}
        backbone.update(found)
    module.bert.load_state_dict(backbone, strict=True)
    head, used = {}, set()
    for k, v in other.items():
        for hf, ours in head_names.items():
            if k.startswith(hf):
                head[ours + k[len(hf):]] = v
                used.add(k)
    if head:
        module.cls.load_state_dict(head, strict=True)
    else:
        logger.info("MLM head initialised from scratch (not in checkpoint)")
    unused = sorted(k for k in set(other) - used
                    if not k.startswith(_TIED_DECODER))
    if unused:
        logger.info("checkpoint params unused by model: %s",
                    unused[:12] + (["..."] if len(unused) > 12 else []))


def export_mlm_state_dict(module):
    """A BertForMaskedLM's weights under the HF names of its model type."""
    prefix, head_names = _mlm_names(module.config)
    out = {prefix + k: v for k, v in module.bert.state_dict().items()}
    back = {ours: hf for hf, ours in head_names.items()}
    for k, v in module.cls.state_dict().items():
        ours = next(o for o in back if k.startswith(o))
        out[back[ours] + k[len(ours):]] = v
    return out


def mlm_state_dict_from_jax(params, config):
    """A BertForMaskedLM state dict from the JAX BertForMaskedLM's param
    tree (numpy leaves): the inverse of the JAX package's
    convert_bert_for_masked_lm ('bert' through state_dict_from_jax, 'cls'
    with its [in, out] transform kernel transposed)."""
    state = {"bert." + k: v
             for k, v in state_dict_from_jax(params["bert"], config).items()}
    state.update({"cls." + k: v
                  for k, v in mlm_head_from_jax(params["cls"]).items()})
    return state


def mlm_head_from_jax(head):
    """A BertMLMHead state dict from the JAX MLM head's params (transform,
    transform_ln, bias), its [in, out] transform kernel transposed."""
    def t(arr):
        return torch.tensor(np.asarray(arr, dtype=np.float32))
    return {"dense.weight": t(np.asarray(head["transform"]["kernel"]).T),
            "dense.bias": t(head["transform"]["bias"]),
            "LayerNorm.weight": t(head["transform_ln"]["scale"]),
            "LayerNorm.bias": t(head["transform_ln"]["bias"]),
            "bias": t(head["bias"])}
