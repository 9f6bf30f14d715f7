"""GLM's SentencePiece tokenizer for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/glm/tokenization_glm.py: the
port's SentencePiece engine (modelzoo/tokenization_sentencepiece.py) with
GLM's eight command tokens ([CLS], [MASK], [gMASK], [sMASK], <|startofpiece|>,
<|endofpiece|>, [UNUSED1], [UNUSED2]) taking the ids after the model's
pieces; `gmask_token_id`, `smask_token_id`, `sop_token_id` and
`eop_token_id` name theirs.
"""

from easynlp_tpu_torch.modelzoo.tokenization_sentencepiece import (
    SentencePieceTokenizer,
)

GLM_COMMAND_TOKENS = (
    "[CLS]", "[MASK]", "[gMASK]", "[sMASK]", "<|startofpiece|>",
    "<|endofpiece|>", "[UNUSED1]", "[UNUSED2]",
)


class GLMTokenizer(SentencePieceTokenizer):
    def __init__(self, sp_model_file, command_tokens=GLM_COMMAND_TOKENS,
                 **kwargs):
        kwargs.setdefault("added_tokens", list(command_tokens))
        kwargs.setdefault("cls_token", "[CLS]")
        kwargs.setdefault("mask_token", "[MASK]")
        kwargs.setdefault("eos_token", "</s>")
        kwargs.setdefault("pad_token", "<pad>")
        kwargs.pop("command_tokens", None)
        super().__init__(sp_model_file, **kwargs)
        self.command_tokens = list(command_tokens)

    @property
    def gmask_token_id(self):
        return self._convert_token_to_id("[gMASK]")

    @property
    def smask_token_id(self):
        return self._convert_token_to_id("[sMASK]")

    @property
    def sop_token_id(self):
        return self._convert_token_to_id("<|startofpiece|>")

    @property
    def eop_token_id(self):
        return self._convert_token_to_id("<|endofpiece|>")

    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        cls = [self.cls_token_id]
        eos = [self.eos_token_id]
        if ids_b is None:
            return cls + list(ids_a) + eos
        return cls + list(ids_a) + eos + list(ids_b) + eos
