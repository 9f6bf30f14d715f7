"""Tokenizer routing by a checkpoint's model_type, for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/api.py::_tokenizer_for over
easynlp_tpu/modelzoo/models/auto/auto_factory.py, reduced to the ported
families: GPT-2's byte-level BPE for `gpt2`; for `bart` the same BPE with
BART's own specials (<s>, </s>, <pad>, <unk>, <mask>) where the vocabulary
holds </s> at the config's EOS id, else the GPT-2 tokenizer, which is what
the JAX route gives every BART checkpoint (ROADMAP C11); WordPiece otherwise
(as the JAX route falls back to BertTokenizer for an unknown model_type or a
directory with no config.json). The SentencePiece tokenizers of T5, mT5,
Pegasus, Randeng and GLM are not ported: those model types raise.
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


_SENTENCEPIECE = ("t5", "mt5", "pegasus", "randeng", "glm")


def tokenizer_for(model_dir):
    config = _config_of(model_dir)
    model_type = config.get("model_type")
    if model_type == "bart":
        from easynlp_tpu_torch.modelzoo.models.bart import BartTokenizer
        if BartTokenizer.fits(model_dir, config.get("eos_token_id", 2)):
            return BartTokenizer.from_pretrained(model_dir)
    if model_type in ("gpt2", "bart"):
        from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
        return GPT2Tokenizer.from_pretrained(model_dir)
    if model_type in _SENTENCEPIECE:
        raise NotImplementedError(
            "the %s tokenizer (SentencePiece) is not ported yet (ROADMAP "
            "A18)" % model_type)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    return BertTokenizer.from_pretrained(model_dir)
