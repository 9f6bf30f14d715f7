"""BERT config for the PyTorch port: the JAX package's PretrainedConfig
(which imports no JAX), so reference config.json files load unchanged."""

from easynlp_tpu.modelzoo.configuration_utils import PretrainedConfig


class BertConfig(PretrainedConfig):
    model_type = "bert"
