"""Config, model and tokenizer routing by a checkpoint's model_type, for the
PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/auto/auto_factory.py and
easynlp_tpu/appzoo/api.py::_tokenizer_for, reduced to the ported
families: `bert`, `roberta`, `gpt2`, `bart`, `t5`, `mt5`, `pegasus`,
`randeng`, `transformer`, `megatron_bert` (also HF's spelling
`megatron-bert`), `kbert`, `dkplm`, `kangaroo`, `ckbert`, `glm`, `clip`
(the Chinese-CLIP dual tower; HF's `chinese_clip` spelling too), `cnn`
(TextCNN) and `bloom`: every family of the JAX AutoConfig.
AutoModel.from_pretrained
returns the port's module with its weights loaded, from a
`pytorch_model.bin` under HF/reference names or from the JAX package's
`flax_params.msgpack` (through the family's state_dict_from_jax); the JAX
AutoModel has no converter for megatron_bert, kbert, dkplm, kangaroo and
ckbert (ROADMAP reference fault 22), the port's modules keep the
reference names and need none. MegatronBERT and K-BERT have no app in
either package: this is their entry point.

`tokenizer_for`, the api's routing: GPT-2's byte-level BPE for `gpt2`;
RoBERTa's (the same BPE with <s>, </s>, <pad>, <unk>, <mask>) for
`roberta`; for `bart` the same BPE with BART's own specials where the
vocabulary holds </s> at the config's EOS id, else the GPT-2 tokenizer,
which is what the JAX route gives every BART checkpoint (ROADMAP C11);
SentencePiece for `t5`, `mt5` (T5Tokenizer) and `pegasus`
(PegasusTokenizer); Randeng's WordPiece (RandengTokenizer) for `randeng`;
subword-nmt BPE (TransformerTokenizer) for `transformer`; GPT-2's BPE for
`bloom` (the JAX TOKENIZER_MAPPING's row); WordPiece otherwise (as the
JAX route falls back to BertTokenizer for an unknown model_type or a
directory with no config.json); GLMTokenizer (the
SentencePiece engine with GLM's command tokens) for `glm`.
`bert_config_for` gives RobertaConfig to a `roberta`
checkpoint and BertConfig to the others, as the JAX AutoConfig maps them.
"""

import json
import os

from easynlp_tpu_torch.utils.io_utils import io


def _config_of(model_dir):
    """config.json under model_dir as a dict ({} when there is none)."""
    from easynlp_tpu_torch.utils import get_pretrain_model_path
    path = os.path.join(get_pretrain_model_path(model_dir), "config.json")
    if not io.exists(path):
        return {}
    with io.open(path) as f:
        return json.load(f)


def model_type_of(model_dir):
    """config.json's model_type under model_dir, or None."""
    return _config_of(model_dir).get("model_type")


# model_type -> (module under modelzoo/models, tokenizer class), the JAX
# TOKENIZER_MAPPING's rows for these families (auto_factory.py:81-85, :98)
_TOKENIZERS = {
    "t5": ("t5", "T5Tokenizer"),
    "mt5": ("t5", "MT5Tokenizer"),
    "pegasus": ("pegasus", "PegasusTokenizer"),
    "randeng": ("randeng", "RandengTokenizer"),
    "transformer": ("transformer", "TransformerTokenizer"),
    "glm": ("glm", "GLMTokenizer"),
}


def bert_config_for(model_dir):
    """model_dir's config as RobertaConfig for model_type `roberta`, else
    as BertConfig."""
    from easynlp_tpu_torch.modelzoo.models.bert import (BertConfig,
                                                         RobertaConfig)
    cls = RobertaConfig if model_type_of(model_dir) == "roberta" \
        else BertConfig
    return cls.from_pretrained(model_dir)


def tokenizer_for(model_dir):
    config = _config_of(model_dir)
    model_type = config.get("model_type")
    if model_type == "roberta":
        from easynlp_tpu_torch.modelzoo.models.bert import RobertaTokenizer
        return RobertaTokenizer.from_pretrained(model_dir)
    if model_type == "bart":
        from easynlp_tpu_torch.modelzoo.models.bart import BartTokenizer
        if BartTokenizer.fits(model_dir, config.get("eos_token_id", 2)):
            return BartTokenizer.from_pretrained(model_dir)
    if model_type in ("gpt2", "bart", "bloom"):
        from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
        return GPT2Tokenizer.from_pretrained(model_dir)
    if model_type in _TOKENIZERS:
        import importlib
        module, name = _TOKENIZERS[model_type]
        cls = getattr(importlib.import_module(_M + module), name)
        return cls.from_pretrained(model_dir)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    return BertTokenizer.from_pretrained(model_dir)


_M = "easynlp_tpu_torch.modelzoo.models."
# model_type -> (module under modelzoo/models, config class, model class)
PORTED = {
    "bert": ("bert", "BertConfig", "BertModel"),
    "roberta": ("bert", "RobertaConfig", "BertModel"),
    "gpt2": ("gpt2", "GPT2Config", "GPT2LMHeadModel"),
    "bart": ("bart", "BartConfig", "BartForConditionalGeneration"),
    "t5": ("t5", "T5Config", "T5ForConditionalGeneration"),
    "mt5": ("t5", "MT5Config", "T5ForConditionalGeneration"),
    "pegasus": ("pegasus", "PegasusConfig",
                "PegasusForConditionalGeneration"),
    "randeng": ("randeng", "RandengConfig",
                "RandengForConditionalGeneration"),
    "transformer": ("transformer", "TransformerConfig",
                    "TransformerGeneratorModel"),
    "megatron_bert": ("megatron_bert", "MegatronBertConfig",
                      "MegatronBertModel"),
    "kbert": ("kbert", "KBertConfig", "KBertModel"),
    "dkplm": ("dkplm", "DKPLMConfig", "DKPLMModel"),
    "kangaroo": ("kangaroo", "KangarooConfig", "KangarooModel"),
    "ckbert": ("ckbert", "CKBertConfig", "CKBertForPreTraining"),
    "glm": ("glm", "GLMConfig", "GLMForConditionalGeneration"),
    "clip": ("clip", "CLIPConfig", "CLIPModel"),
    "cnn": ("cnn", "TextCNNConfig", "TextCNNModel"),
    "bloom": ("bloom", "BloomConfig", "BloomForCausalLM"),
}
# HF config.json's spellings
_ALIASES = {"megatron-bert": "megatron_bert", "chinese_clip": "clip"}
# the families whose checkpoints the sequence_generation app reads
_GENERATION = ("gpt2", "bart", "t5", "mt5", "pegasus", "randeng",
               "transformer")


def _classes(model_type):
    """(model_type, config class, model class) of a ported family."""
    import importlib
    model_type = _ALIASES.get(model_type, model_type)
    if model_type not in PORTED:
        raise KeyError("unknown model_type %r (the port has %s)"
                       % (model_type, sorted(PORTED)))
    module, config_cls, model_cls = PORTED[model_type]
    module = importlib.import_module(_M + module)
    return model_type, getattr(module, config_cls), getattr(module,
                                                           model_cls)


def _family(model_dir):
    """_classes of model_dir's config.json model_type."""
    config = _config_of(model_dir)
    if not config:
        raise FileNotFoundError("no config.json under %r" % model_dir)
    if not config.get("model_type"):
        raise ValueError("config.json at %r has no model_type" % model_dir)
    return _classes(config["model_type"])


class AutoConfig:
    @classmethod
    def from_pretrained(cls, model_dir):
        _, config_cls, _ = _family(model_dir)
        return config_cls.from_pretrained(model_dir)


class AutoTokenizer:
    @classmethod
    def from_pretrained(cls, model_dir):
        _family(model_dir)
        return tokenizer_for(model_dir)


def _strip(state_dict, prefixes):
    """gamma/beta renamed and one leading prefix of `prefixes` dropped."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k.replace(".gamma", ".weight").replace(".beta", ".bias")] = v
    return out


def _load_pytorch(model_type, module, state_dict):
    """A reference/HF checkpoint into `module`, strictly: the module's own
    names, under the family's prefix in the checkpoint or none; keys of
    other parts (task heads) are left aside."""
    if model_type in _GENERATION:
        from easynlp_tpu_torch.appzoo.sequence_generation.model import (
            SequenceGeneration)
        SequenceGeneration.load_state_dict(module, state_dict)
    elif model_type == "ckbert":
        from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
            load_mlm_state_dict)
        load_mlm_state_dict(module, state_dict)
    elif model_type == "glm":
        from easynlp_tpu_torch.modelzoo.models.glm.conversion import (
            normalize_keys)
        module.load_state_dict(normalize_keys(state_dict), strict=True)
    elif model_type == "clip":
        from easynlp_tpu_torch.modelzoo.models.clip import conversion
        conversion.load_clip_state_dict(
            module, conversion.normalize_keys(state_dict))
    elif model_type == "bloom":
        from easynlp_tpu_torch.modelzoo.models.bloom.modeling_bloom import (
            normalize_keys)
        module.load_state_dict(normalize_keys(state_dict), strict=True)
    else:
        state = _strip(state_dict, ("bert.", "roberta.", "kangaroo."))
        own = module.state_dict()
        module.load_state_dict({k: v for k, v in state.items() if k in own},
                               strict=True)


def _from_jax(model_type, params, config):
    import importlib
    if model_type in _GENERATION:
        from easynlp_tpu_torch.appzoo.sequence_generation.model import (
            SequenceGeneration)
        return SequenceGeneration.state_dict_from_jax(params, config)
    if model_type == "ckbert":
        from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
            mlm_state_dict_from_jax)
        return mlm_state_dict_from_jax(params, config)
    if model_type == "kangaroo":
        from easynlp_tpu_torch.modelzoo.models.kangaroo.modeling_kangaroo \
            import model_state_dict_from_jax
        return model_state_dict_from_jax(params, config)
    name = {"bert": "bert.conversion", "roberta": "bert.conversion",
            "glm": "glm.conversion", "clip": "clip.conversion",
            "megatron_bert": "megatron_bert",
            "kbert": "kbert.modeling_kbert",
            "dkplm": "dkplm.modeling_dkplm", "cnn": "cnn.modeling_cnn",
            "bloom": "bloom.modeling_bloom"}[model_type]
    return importlib.import_module(_M + name).state_dict_from_jax(params,
                                                                  config)


class AutoModel:
    @classmethod
    def from_config(cls, config, dtype=None, device="cuda"):
        """The module of config.model_type, at its init from seed 0, on
        `device` (the card unless the caller asks for the CPU)."""
        import torch
        _, _, model_cls = _classes(config.model_type)
        device = torch.device(device)
        module = model_cls(config, dtype=dtype or torch.float32,
                           device=device)
        module.init_weights(torch.Generator(device=device).manual_seed(0))
        return module

    @classmethod
    def from_pretrained(cls, model_dir, dtype=None, device="cuda"):
        """The port's module of model_dir's model_type, its weights loaded
        from pytorch_model.bin or, where there is only that, the JAX
        package's flax_params.msgpack; in eval mode on `device`."""
        import torch

        from easynlp_tpu_torch.modelzoo.modeling_utils import (
            PARAMS_NAME, available_checkpoint, load_pytorch_state_dict)
        model_type, config_cls, _ = _family(model_dir)
        config = config_cls.from_pretrained(model_dir)
        device = torch.device(device)
        module = cls.from_config(config, dtype=dtype, device=device)
        flavour = available_checkpoint(model_dir)
        if flavour == "pytorch":
            _load_pytorch(model_type, module,
                          load_pytorch_state_dict(model_dir))
        elif flavour == "flax":
            from easynlp_tpu_torch.utils.flax_checkpoint import (
                load_flax_params)
            params = load_flax_params(os.path.join(model_dir, PARAMS_NAME))
            module.load_state_dict(_from_jax(model_type, params, config),
                                   strict=True)
        else:
            raise FileNotFoundError(
                "no pytorch_model.bin or %s under %r" % (PARAMS_NAME,
                                                          model_dir))
        return module.eval()
