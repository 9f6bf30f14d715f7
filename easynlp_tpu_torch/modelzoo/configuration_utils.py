"""Config base class for the PyTorch port (its own copy of
easynlp_tpu/modelzoo/configuration_utils.py): a typed attribute bag with HF
attribute names and a config.json round trip; model families declare their
defaults by subclassing."""

import copy
import json
import os

from easynlp_tpu_torch.utils.io_utils import io

CONFIG_NAME = "config.json"


class PretrainedConfig:
    model_type = ""

    # Common defaults shared by the zoo (HF-compatible attribute names so
    # reference checkpoints' config.json load unchanged).
    def __init__(self, **kwargs):
        self.vocab_size = kwargs.pop("vocab_size", 30522)
        self.hidden_size = kwargs.pop("hidden_size", 768)
        self.num_hidden_layers = kwargs.pop("num_hidden_layers", 12)
        self.num_attention_heads = kwargs.pop("num_attention_heads", 12)
        self.intermediate_size = kwargs.pop("intermediate_size", 3072)
        self.hidden_act = kwargs.pop("hidden_act", "gelu")
        self.hidden_dropout_prob = kwargs.pop("hidden_dropout_prob", 0.1)
        self.attention_probs_dropout_prob = kwargs.pop(
            "attention_probs_dropout_prob", 0.1)
        self.max_position_embeddings = kwargs.pop("max_position_embeddings", 512)
        self.type_vocab_size = kwargs.pop("type_vocab_size", 2)
        self.initializer_range = kwargs.pop("initializer_range", 0.02)
        self.layer_norm_eps = kwargs.pop("layer_norm_eps", 1e-12)
        self.pad_token_id = kwargs.pop("pad_token_id", 0)
        self.bos_token_id = kwargs.pop("bos_token_id", None)
        self.eos_token_id = kwargs.pop("eos_token_id", None)
        self.is_encoder_decoder = kwargs.pop("is_encoder_decoder", False)
        self.is_decoder = kwargs.pop("is_decoder", False)
        self.num_labels = kwargs.pop("num_labels", 2)
        self.use_cache = kwargs.pop("use_cache", True)
        self.tie_word_embeddings = kwargs.pop("tie_word_embeddings", True)
        # Everything else is kept verbatim so checkpoint configs round-trip.
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- dict/json round trip ------------------------------------------------
    def to_dict(self):
        output = copy.deepcopy(self.__dict__)
        output["model_type"] = self.model_type
        return output

    def to_json_string(self):
        return json.dumps(self.to_dict(), indent=2, sort_keys=True,
                          ensure_ascii=False) + "\n"

    def save_pretrained(self, save_directory):
        io.makedirs(save_directory)
        with io.open(os.path.join(save_directory, CONFIG_NAME), "w") as f:
            f.write(self.to_json_string())

    @classmethod
    def from_dict(cls, config_dict, **overrides):
        config_dict = dict(config_dict)
        config_dict.pop("model_type", None)
        config_dict.update(overrides)
        return cls(**config_dict)

    @classmethod
    def from_json_file(cls, json_file, **overrides):
        with io.open(json_file) as f:
            return cls.from_dict(json.load(f), **overrides)

    @classmethod
    def from_pretrained(cls, name_or_path, **overrides):
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        path = get_pretrain_model_path(name_or_path)
        cfg_file = path if str(path).endswith(".json") else os.path.join(
            path, CONFIG_NAME)
        if io.exists(cfg_file):
            return cls.from_json_file(cfg_file, **overrides)
        raise FileNotFoundError("no %s under %r" % (CONFIG_NAME, name_or_path))

    def __repr__(self):
        return "%s %s" % (type(self).__name__, self.to_json_string())
