"""Checkpoint keys and layouts for the port's T5 / mT5.

The port's module carries HF T5ForConditionalGeneration's names, so an HF or
reference `pytorch_model.bin` needs only key normalisation (normalize_keys):
the per-stack `embed_tokens.weight` copies of `shared.weight` are dropped,
and so is `lm_head.weight` where the embeddings are tied (the head reads
`shared`). The result loads with strict=True. `state_dict_from_jax` reads
the JAX package's layout (the inverse of
easynlp_tpu/modelzoo/models/t5/conversion.py's convert_t5_state_dict): the
scanned [L, ...] stacks are unstacked onto per-layer names, each stack's
`rel_bias.rel_embedding` becomes block 0's `relative_attention_bias`, and
Dense kernels [in, out] become nn.Linear's [out, in].
"""

import numpy as np
import torch


def normalize_keys(state_dict, config):
    """T5ForConditionalGeneration state dict from an HF/reference T5 state
    dict."""
    drop = {"encoder.embed_tokens.weight", "decoder.embed_tokens.weight"}
    if config.tie_word_embeddings:
        drop.add("lm_head.weight")
    return {k: v for k, v in state_dict.items() if k not in drop}


def _ffn_names(config):
    return ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")


def state_dict_from_jax(params, config):
    """The port's T5ForConditionalGeneration state dict from a JAX
    T5ForConditionalGeneration param tree with numpy leaves."""
    state = {}

    def put(key, arr):
        state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))

    put("shared.weight", params["shared"]["embedding"])
    for side, n in (("encoder", config.num_layers),
                    ("decoder", config.num_decoder_layers)):
        tree = params[side]
        layers = tree["layers"]
        put(side + ".block.0.layer.0.SelfAttention.relative_attention_bias"
            ".weight", tree["rel_bias"]["rel_embedding"])
        attns = [("self_attn", "ln_self", "SelfAttention")]
        if side == "decoder":
            attns.append(("cross_attn", "ln_cross", "EncDecAttention"))
        for i in range(n):
            base = "%s.block.%d.layer." % (side, i)
            for j, (attn, ln, name) in enumerate(attns):
                for proj in ("q", "k", "v", "o"):
                    put(base + "%d.%s.%s.weight" % (j, name, proj),
                        layers[attn][proj]["kernel"][i].T)
                put(base + "%d.layer_norm.weight" % j, layers[ln]["scale"][i])
            j = len(attns)
            for proj in _ffn_names(config):
                put(base + "%d.DenseReluDense.%s.weight" % (j, proj),
                    layers["ffn"][proj]["kernel"][i].T)
            put(base + "%d.layer_norm.weight" % j, layers["ln_ff"]["scale"][i])
        put(side + ".final_layer_norm.weight", tree["final_ln"]["scale"])
    if not config.tie_word_embeddings:
        put("lm_head.weight", np.asarray(params["lm_head"]["kernel"]).T)
    return state
