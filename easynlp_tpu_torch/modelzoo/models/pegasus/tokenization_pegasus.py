"""Pegasus SentencePiece tokenizer for the PyTorch port (the port's own copy
of easynlp_tpu/modelzoo/models/pegasus/tokenization_pegasus.py).

The SentencePiece unigram model with Pegasus's id layout: 0 <pad>, 1 </s>,
2 <mask_1> (the gap-sentence mask), 3 <mask_2> (the token mask), 4 ..
offset - 1 the pretraining slots <unk_2> .. <unk_102>, and the model's
pieces shifted by `offset` (103). A sequence ends with one </s>.
"""

from easynlp_tpu_torch.modelzoo.tokenization_sentencepiece import (
    SentencePieceTokenizer,
)


class PegasusTokenizer(SentencePieceTokenizer):
    def __init__(self, sp_model_file, offset=103, mask_token="<mask_2>",
                 mask_token_sent="<mask_1>", **kwargs):
        kwargs.setdefault("pad_token", "<pad>")
        kwargs.setdefault("eos_token", "</s>")
        kwargs.setdefault("unk_token", "<unk>")
        super().__init__(sp_model_file, mask_token=mask_token, **kwargs)
        self.offset = offset
        self.mask_token_sent = mask_token_sent
        self.init_kwargs.update(offset=offset, mask_token_sent=mask_token_sent)
        self.encoder = {0: self.pad_token, 1: self.eos_token}
        if mask_token_sent is not None:
            self.encoder[2] = mask_token_sent
            self.encoder[3] = mask_token
        # ids 4 .. offset + 1 hold <unk_2> .. <unk_{offset-1}>
        for i in range(2, offset):
            self.encoder[i + 2] = "<unk_%d>" % i
        self.decoder = {v: k for k, v in self.encoder.items()}

    @property
    def vocab_size(self):
        return len(self.sp) + self.offset

    def get_vocab(self):
        v = {self.sp.id_to_piece(i): i + self.offset
             for i in range(len(self.sp))}
        v.update(self.decoder)
        return v

    def _encode_core(self, text):
        return [i + self.offset for i in self.sp.encode(text)]

    def _convert_token_to_id(self, token):
        if token in self.decoder:
            return self.decoder[token]
        return self.sp.piece_to_id.get(token, self.sp.unk_id) + self.offset

    def _convert_id_to_token(self, index):
        if index in self.encoder:
            return self.encoder[index]
        if 0 <= index - self.offset < len(self.sp):
            return self.sp.id_to_piece(index - self.offset)
        return self.unk_token

    def decode(self, ids, skip_special_tokens=True):
        specials = set(self.decoder.values()) if skip_special_tokens else set()
        core = [self._known(int(i) - self.offset) for i in ids
                if int(i) not in specials and int(i) >= self.offset]
        return self.sp.decode(core)

    def num_special_tokens_to_add(self, pair=False):
        return 1  # </s>

    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        if ids_b is None:
            return list(ids_a) + [self.eos_token_id]
        return list(ids_a) + list(ids_b) + [self.eos_token_id]

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        return [0] * len(self.build_inputs_with_special_tokens(ids_a, ids_b))
