"""Checkpoint keys and layouts for the port's BART, Pegasus, Randeng and
dialogue `transformer`.

The port's module carries the HF names under `model.`, so a reference/HF
BART or Pegasus `pytorch_model.bin` needs only key normalisation
(normalize_keys): the
`model.` prefix added where a checkpoint lacks it, each stack's
`embed_tokens.weight` filled from `shared.weight` where absent, the tied
`lm_head.weight` and `shared.weight` dropped (the head reads the decoder's
embedding, as in the JAX model), and `final_logits_bias` taken as [1,V]
(zeros where absent), `layernorm_embedding` dropped where the config
has none (use_layernorm_embedding=False), and the sinusoidal
`embed_positions` tables dropped where the positions are sinusoidal (they
are recomputed, as the JAX package's convert_pegasus_state_dict skips
them). The result loads with strict=True.
`state_dict_from_jax` goes the other way from the JAX package's own layout
(the inverse of easynlp_tpu/modelzoo/models/bart/conversion.py's
convert_bart_state_dict).
"""

import numpy as np
import torch

_DROPPED = ("lm_head.weight", "model.shared.weight")


def normalize_keys(state_dict, config):
    """BartForConditionalGeneration state dict from a reference/HF BART
    state dict."""
    s = {}
    for k, v in state_dict.items():
        if k != "final_logits_bias" and not k.startswith(("model.", "lm_head")):
            k = "model." + k
        s[k] = v
    shared = s.get("model.shared.weight")
    for side in ("encoder", "decoder"):
        key = "model.%s.embed_tokens.weight" % side
        if key not in s and shared is not None:
            s[key] = shared
    if not config.use_layernorm_embedding:
        # the model has none, and the JAX conversion skips them too
        s = {k: v for k, v in s.items() if ".layernorm_embedding." not in k}
    if config.position_type != "learned":
        s = {k: v for k, v in s.items()
             if not k.endswith(".embed_positions.weight")}
    bias = s.get("final_logits_bias")
    s["final_logits_bias"] = (
        torch.zeros(1, config.vocab_size) if bias is None
        else torch.as_tensor(bias).reshape(1, -1))
    return {k: v for k, v in s.items() if k not in _DROPPED}


def state_dict_from_jax(params, config):
    """The port's BartForConditionalGeneration state dict from a JAX
    BartForConditionalGeneration param tree with numpy leaves: unstacks the
    [L, ...] scanned layers and transposes Dense kernels [in, out] to
    nn.Linear's [out, in]."""
    state = {}

    def put(key, arr):
        state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))

    for side, n in (("encoder", config.encoder_layers),
                    ("decoder", config.decoder_layers)):
        tree = params[side]
        base = "model.%s." % side
        put(base + "embed_tokens.weight", tree["embed_tokens"]["embedding"])
        if config.position_type == "learned":
            put(base + "embed_positions.weight", tree["embed_positions"])
        if config.final_layer_norm:
            put(base + "layer_norm.weight", tree["layer_norm"]["scale"])
            put(base + "layer_norm.bias", tree["layer_norm"]["bias"])
        if config.use_layernorm_embedding:
            put(base + "layernorm_embedding.weight",
                tree["layernorm_embedding"]["scale"])
            put(base + "layernorm_embedding.bias",
                tree["layernorm_embedding"]["bias"])
        layers = tree["layers"]
        attns = ("self_attn", "encoder_attn") if side == "decoder" \
            else ("self_attn",)
        for i in range(n):
            pre = base + "layers.%d." % i
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    put(pre + "%s.%s.weight" % (attn, proj),
                        layers[attn][proj]["kernel"][i].T)
                    put(pre + "%s.%s.bias" % (attn, proj),
                        layers[attn][proj]["bias"][i])
                ln = layers[attn + "_layer_norm"]
                put(pre + attn + "_layer_norm.weight", ln["scale"][i])
                put(pre + attn + "_layer_norm.bias", ln["bias"][i])
            for fc in ("fc1", "fc2"):
                put(pre + fc + ".weight", layers[fc]["kernel"][i].T)
                put(pre + fc + ".bias", layers[fc]["bias"][i])
            put(pre + "final_layer_norm.weight",
                layers["final_layer_norm"]["scale"][i])
            put(pre + "final_layer_norm.bias",
                layers["final_layer_norm"]["bias"][i])
    put("final_logits_bias", np.asarray(params["final_logits_bias"])[None])
    return state
