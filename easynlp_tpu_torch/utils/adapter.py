"""TF checkpoint adapter of the PyTorch port (its own copy of
easynlp_tpu/utils/adapter.py).

Capability parity: reference easynlp/utils/adapter.py:25-296
(load_bert_tf_checkpoint_weights: Google-BERT TF v1 checkpoints into model
weights, skipping optimizer slots). The port's BertModel keeps HF's
parameter names, so a TF variable maps onto one parameter by name
(`tf_name` below: bert/encoder/layer_N/attention/self/query/kernel is
encoder.layer.N.attention.self.query.weight); TF kernels are [in, out] and
torch's nn.Linear weights [out, in], so kernels are transposed. TensorFlow
is imported only inside the loader, as in the JAX package.
"""

import re

import numpy as np
import torch

from easynlp_tpu_torch.utils.logger import logger

# optimizer slots and step counters (reference adapter.py:70-74)
_SKIPPED = ("Adam", "adam_", "global_step", "beta1_power", "beta2_power")


def tf_name(name):
    """The Google-BERT TF variable name of a BertModel parameter (HF name,
    without the `bert.` prefix), and whether its TF value is the
    transpose (a dense kernel)."""
    parts = re.sub(r"\.layer\.(\d+)\.", r".layer_\1.", name).split(".")
    leaf = parts.pop()
    owner = parts[-1]
    if owner == "LayerNorm":
        parts.append({"weight": "gamma", "bias": "beta"}[leaf])
        transpose = False
    elif owner.endswith("embeddings"):
        transpose = False   # the table itself: bert/embeddings/<name>
    else:
        parts.append({"weight": "kernel", "bias": "bias"}[leaf])
        transpose = leaf == "weight"
    return "bert/" + "/".join(parts), transpose


def load_bert_tf_checkpoint(tf_checkpoint_path):
    """A Google-BERT TF checkpoint as the port's BertModel state dict
    ({HF name: f32 tensor}; the names carry the layer count)."""
    import tensorflow as tf

    variables = {}
    for name, _ in tf.train.list_variables(tf_checkpoint_path):
        if any(s in name for s in _SKIPPED):
            continue
        variables[name] = np.asarray(
            tf.train.load_variable(tf_checkpoint_path, name))
    logger.info("TF checkpoint: %d variables from %s", len(variables),
                tf_checkpoint_path)
    by_tf = {}
    for name in variables:
        if not name.startswith("bert/"):
            continue
        hf = name[len("bert/"):]
        hf = re.sub(r"layer_(\d+)", r"layer.\1", hf).replace("/", ".")
        if hf.endswith(".gamma") or hf.endswith(".beta"):
            hf = hf.rsplit(".", 1)[0] + (".weight" if hf.endswith("gamma")
                                         else ".bias")
        elif hf.endswith(".kernel"):
            hf = hf[:-len(".kernel")] + ".weight"
        elif not hf.endswith(".bias"):
            hf = hf + ".weight"     # an embedding table
        by_tf[hf] = name
    state = {}
    for hf, name in by_tf.items():
        arr = variables[name]
        if tf_name(hf)[1]:
            arr = arr.T
        state[hf] = torch.from_numpy(np.ascontiguousarray(arr,
                                                          dtype=np.float32))
    return state
