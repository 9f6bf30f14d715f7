"""TextCNN for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/cnn/modeling_cnn.py: token
embeddings (f32 table, cast to the compute dtype), one Conv1d a kernel
size with flax's "SAME" padding ((k - 1) // 2 on the left, the rest on the
right, so an even size pads one more on the right), ReLU, the padded
positions set to -1e30 before a max over the sequence, the pooled
features concatenated, then dropout. Returns {'pooler_output' [B,
num_filters * len(kernel_sizes)], 'last_hidden_state': the embeddings}.
Parameter names: `embeddings.weight`, `conv_{k}.weight` [F, E, k] and
`conv_{k}.bias`.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_


class TextCNNConfig(PretrainedConfig):
    model_type = "cnn"

    def __init__(self, vocab_size=21128, embedding_size=128,
                 kernel_sizes=(2, 3, 4, 5), num_filters=100, **kwargs):
        self.embedding_size = embedding_size
        self.kernel_sizes = tuple(kernel_sizes)
        self.num_filters = num_filters
        kwargs.setdefault("hidden_size",
                          num_filters * len(self.kernel_sizes))
        super().__init__(vocab_size=vocab_size, **kwargs)


class TextCNNModel(nn.Module):
    tensor_table = "cnn"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = nn.Embedding(config.vocab_size,
                                       config.embedding_size, device=device)
        for k in config.kernel_sizes:
            self.add_module("conv_%d" % k, nn.Conv1d(
                config.embedding_size, config.num_filters, k, device=device))
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal(initializer_range) embeddings; lecun-normal
        kernels (flax Conv's default) with zero biases."""
        truncated_normal_(self.embeddings.weight,
                          self.config.initializer_range, generator)
        for k in self.config.kernel_sizes:
            conv = getattr(self, "conv_%d" % k)
            fan_in = conv.weight[0].numel()
            truncated_normal_(conv.weight, 1.0 / math.sqrt(fan_in)
                              / 0.87962566103423978, generator)
            conv.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        dt = self.dtype
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        emb = self.embeddings(input_ids).to(dt)
        x = emb.transpose(1, 2)  # [B, E, S]
        hidden = attention_mask[:, None, :] > 0
        feats = []
        for k in self.config.kernel_sizes:
            conv = getattr(self, "conv_%d" % k)
            lo = (k - 1) // 2
            h = F.conv1d(F.pad(x, (lo, k - 1 - lo)), conv.weight.to(dt),
                         conv.bias.to(dt))
            h = torch.relu(h).masked_fill(~hidden, -1e30)
            feats.append(h.amax(dim=-1))
        pooled = self.dropout(torch.cat(feats, dim=-1))
        return {"pooler_output": pooled, "last_hidden_state": emb}


def state_dict_from_jax(params, config):
    """The port's TextCNNModel state dict from the JAX module's params:
    flax Conv kernels [k, E, F] -> [F, E, k]."""
    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))
    state = {"embeddings.weight": t(params["embeddings"]["embedding"])}
    for k in config.kernel_sizes:
        p = params["conv_%d" % k]
        state["conv_%d.weight" % k] = t(np.asarray(p["kernel"])
                                        .transpose(2, 1, 0))
        state["conv_%d.bias" % k] = t(p["bias"])
    return state
