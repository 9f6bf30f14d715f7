"""Synthetic setups for benchmarks, dry runs and tests: the PyTorch port's
own copy of easynlp_tpu/testing.py, over the port's BertConfig and flags.
(JAX's `zeros_like_init` builds a flax param tree; a torch module is made
zero with `torch.nn.init.zeros_` on its parameters, so it has no copy
here.)"""

import numpy as np

from easynlp_tpu_torch.modelzoo.models.bert import BertConfig


class SyntheticClassificationDataset:
    """Random fixed-shape classification rows matching the app contract:
    the JAX package's rows for the same arguments, bit for bit."""

    def __init__(self, n, seq_len, vocab_size, num_labels=2, seed=0):
        rng = np.random.RandomState(seed)
        self.features = {
            "input_ids": rng.randint(5, vocab_size, (n, seq_len)).astype(
                np.int32),
            "attention_mask": np.ones((n, seq_len), np.int32),
            "token_type_ids": np.zeros((n, seq_len), np.int32),
            "label_ids": rng.randint(0, num_labels, (n,)).astype(np.int32),
        }
        self.label_mapping = {str(i): i for i in range(num_labels)}
        self.n = n

    @property
    def label_enumerate_values(self):
        return list(self.label_mapping)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def make_args(**overrides):
    """The flags' defaults with `overrides` set, registered as the global
    args, for a Trainer or Evaluator built without the CLI."""
    from easynlp_tpu_torch.utils.arguments import parse_args
    from easynlp_tpu_torch.utils.global_vars import set_global_args
    args = parse_args(args_list=[])
    for k, v in overrides.items():
        setattr(args, k, v)
    set_global_args(args)
    return args


def bert_base_config(vocab_size=30522, seq_len=512):
    return BertConfig(vocab_size=vocab_size, hidden_size=768,
                      num_hidden_layers=12, num_attention_heads=12,
                      intermediate_size=3072, max_position_embeddings=seq_len)


def tiny_bert_config(vocab_size=1000, **overrides):
    kw = dict(vocab_size=vocab_size, hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=64)
    kw.update(overrides)
    return BertConfig(**kw)
