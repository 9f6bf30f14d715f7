"""Tokenizer routing by a checkpoint's model_type, for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/api.py::_tokenizer_for over
easynlp_tpu/modelzoo/models/auto/auto_factory.py, reduced to the ported
families: GPT-2's byte-level BPE for `gpt2` and `bart` (the JAX route gives
BART the GPT-2 tokenizer too), WordPiece otherwise (as the JAX route falls
back to BertTokenizer for an unknown model_type or a directory with no
config.json). The SentencePiece tokenizers of T5, mT5, Pegasus, Randeng and
GLM are not ported: those model types raise.
"""

import json
import os

from easynlp_tpu_torch.utils.io_utils import io


def model_type_of(model_dir):
    """config.json's model_type under model_dir, or None."""
    from easynlp_tpu_torch.utils import get_pretrain_model_path
    path = os.path.join(get_pretrain_model_path(model_dir), "config.json")
    if not io.exists(path):
        return None
    with io.open(path) as f:
        return json.load(f).get("model_type")


_SENTENCEPIECE = ("t5", "mt5", "pegasus", "randeng", "glm")


def tokenizer_for(model_dir):
    model_type = model_type_of(model_dir)
    if model_type in ("gpt2", "bart"):
        from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
        return GPT2Tokenizer.from_pretrained(model_dir)
    if model_type in _SENTENCEPIECE:
        raise NotImplementedError(
            "the %s tokenizer (SentencePiece) is not ported yet (ROADMAP "
            "A18)" % model_type)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    return BertTokenizer.from_pretrained(model_dir)
