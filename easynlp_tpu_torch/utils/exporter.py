"""Checkpoint export of the PyTorch port (its own copy of
easynlp_tpu/utils/exporter.py).

Capability parity: reference easynlp/utils/exporter.py (TF checkpoint export
:81-193; train_config.json and label_mapping.json are written by the
Trainer). The port's BERT already carries HF's parameter names, so the
PyTorch export is the backbone's state dict under the `bert.` prefix (what
HF's BertModel loads, the JAX package's export_bert_backbone_to_pytorch
output key for key); the TF export writes the Google-BERT v1 names
(utils/adapter.tf_name), kernels transposed to TF's [in, out]. TensorFlow
is imported only inside export_tf_checkpoint: where it is not installed,
that raises naming the missing package.
"""

import numpy as np
import torch

from easynlp_tpu_torch.utils.adapter import tf_name
from easynlp_tpu_torch.utils.logger import logger


def _backbone_state(backbone):
    """{HF name: contiguous f32 CPU tensor} of a BertModel (or of its state
    dict)."""
    state = backbone if isinstance(backbone, dict) else \
        backbone.state_dict()
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in state.items()}


def export_bert_backbone_to_pytorch(backbone, output_path, prefix="bert."):
    """Write a BertModel's weights as a pytorch_model.bin under HF names
    (`prefix` + name)."""
    state = {prefix + k: v for k, v in _backbone_state(backbone).items()}
    torch.save(state, output_path)
    logger.info("exported BERT backbone (%d tensors) to %s", len(state),
                output_path)
    return output_path


def export_tf_checkpoint(backbone, output_path):
    """Write a Google-BERT-named TF v1 checkpoint of a BertModel's weights
    (the inverse of utils/adapter.load_bert_tf_checkpoint)."""
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError(
            "export_format=tf needs the tensorflow package, which is not "
            "installed here; export_format=pytorch needs none") from exc
    tensors = {}
    for name, value in _backbone_state(backbone).items():
        key, transpose = tf_name(name)
        arr = value.numpy()
        tensors[key] = np.ascontiguousarray(arr.T if transpose else arr)
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        for name, arr in tensors.items():
            tf1.get_variable(name, initializer=arr.astype(np.float32))
        saver = tf1.train.Saver()
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, output_path, write_meta_graph=False)
    logger.info("exported %d TF variables to %s", len(tensors), output_path)
    return output_path
