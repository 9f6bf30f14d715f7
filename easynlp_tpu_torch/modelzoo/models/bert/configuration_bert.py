"""BERT config for the PyTorch port, on the port's PretrainedConfig (HF
attribute names), so reference config.json files load unchanged."""

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig


class BertConfig(PretrainedConfig):
    model_type = "bert"


class RobertaConfig(BertConfig):
    """RoBERTa on the BERT encoder (the port's copy of the JAX package's
    RobertaConfig): position ids count from padding_idx + 1 over the
    non-pad tokens (pad positions stay at padding_idx) instead of arange,
    pad 1, bos 0, eos 2, one token type."""
    model_type = "roberta"
    position_ids_from_padding_idx = True

    def __init__(self, **kwargs):
        kwargs.setdefault("pad_token_id", 1)
        kwargs.setdefault("bos_token_id", 0)
        kwargs.setdefault("eos_token_id", 2)
        kwargs.setdefault("type_vocab_size", 1)
        super().__init__(**kwargs)
