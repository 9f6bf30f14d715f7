"""BERT config for the PyTorch port, on the port's PretrainedConfig (HF
attribute names), so reference config.json files load unchanged."""

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig


class BertConfig(PretrainedConfig):
    model_type = "bert"
