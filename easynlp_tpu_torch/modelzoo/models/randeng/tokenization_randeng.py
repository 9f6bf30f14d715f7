"""Randeng's tokenizer for the PyTorch port (the port's own copy of
easynlp_tpu/modelzoo/models/randeng/tokenization_randeng.py): WordPiece over
a BERT vocab.txt, not SentencePiece. Where the jieba segmenter is installed
the text is first cut into words, a word found whole in the vocabulary is
kept whole and every other one goes through BERT's basic and WordPiece
tokenizers; without jieba (neither the JAX image nor the card's machine has
it) it is BertTokenizer, native fast path included."""

from easynlp_tpu_torch.modelzoo.models.bert.tokenization_bert import (
    BertTokenizer,
)

try:
    import jieba
except ImportError:
    jieba = None


class RandengTokenizer(BertTokenizer):
    def __init__(self, vocab_file, **kwargs):
        super().__init__(vocab_file, **kwargs)
        if jieba is not None:
            self._fast = None  # the native path has no word-segmenter hook

    def _tokenize(self, text):
        if jieba is None:
            return super()._tokenize(text)
        out = []
        for word in jieba.cut(text, HMM=False):
            if word in self.vocab:
                out.append(word)
            else:
                out.extend(super()._tokenize(word))
        return out
