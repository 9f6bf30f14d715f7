"""Checkpoint keys and layouts for the port's GPT-2.

The port's modules carry the HF names, so a reference/HF `pytorch_model.bin`
needs only key normalisation: the leading `transformer.` stripped, the
tied `lm_head.weight` and HF's `attn.bias` / `attn.masked_bias` causal-mask
buffers dropped. The result loads into GPT2Model with strict=True. Conv1D
weights are already [in, out] on both sides, so nothing is transposed.
`state_dict_from_jax` goes the other way from the JAX package's own layout
(the inverse of easynlp_tpu/modelzoo/models/gpt2/conversion.py).
"""

import numpy as np
import torch

# HF buffers (the causal mask and its fill value) and the tied head; the
# port derives the first two from shapes and ties the head to wte
_DERIVED_SUFFIXES = (".attn.bias", ".attn.masked_bias")
_TIED = "lm_head.weight"


def normalize_keys(state_dict):
    """GPT2Model state dict from a reference/HF GPT-2 state dict."""
    out = {}
    for k, v in state_dict.items():
        k = k[len("transformer."):] if k.startswith("transformer.") else k
        if k == _TIED or k.endswith(_DERIVED_SUFFIXES):
            continue
        out[k] = v
    return out


def state_dict_from_jax(params, config):
    """The port's GPT2Model state dict from a JAX GPT2LMHeadModel param tree
    with numpy leaves ({'transformer': {...}}): unstacks the [L, ...] scanned
    `h` layers; kernels stay [in, out]."""
    p = params["transformer"]
    h = p["h"]
    state = {}

    def put(key, arr):
        state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))

    put("wte.weight", p["wte"]["embedding"])
    put("wpe.weight", p["wpe"]["embedding"])
    for i in range(config.n_layer):
        base = "h.%d." % i
        for name, tree, kind in (("ln_1", h["ln_1"], "ln"),
                                 ("attn.c_attn", h["attn"]["c_attn"], "conv"),
                                 ("attn.c_proj", h["attn"]["c_proj"], "conv"),
                                 ("ln_2", h["ln_2"], "ln"),
                                 ("mlp.c_fc", h["c_fc"], "conv"),
                                 ("mlp.c_proj", h["c_proj"], "conv")):
            put(base + name + ".weight",
                tree["kernel" if kind == "conv" else "scale"][i])
            put(base + name + ".bias", tree["bias"][i])
    put("ln_f.weight", p["ln_f"]["scale"])
    put("ln_f.bias", p["ln_f"]["bias"])
    return state
