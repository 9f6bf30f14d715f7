"""Generation evaluator for the PyTorch port: BLEU-4 and ROUGE-L (the port's
own copy of easynlp_tpu/appzoo/sequence_generation/evaluator.py, same
metrics on the same token ids).

Each valid row is generated from its source (greedy unless num_beams > 1,
at most max_decode_length tokens), and the generated ids, special tokens
removed, are scored against the row's labels (the -100 padding and special
tokens removed): sentence BLEU-4 with +1 smoothing and ROUGE-L F1, averaged
over the rows.

For the encoder-decoders the hypothesis is the decoder's whole buffer,
special ids removed, as in the JAX evaluator. For GPT-2 it is
SequenceGeneration.generated_tokens: the new tokens up to and including
the first EOS. The JAX evaluator scores GPT-2's whole buffer, the prompt
and the pad id 0 ("!") slots after EOS included, against the labels
(ROADMAP reference fault 23). GLM's rows (appzoo/sequence_generation/
glm.py) carry the target after the prefix: as in the JAX evaluator, each
generates from its source alone (the slots before prefix_lengths - 1,
gMASK dropped, which GLM's generate appends again) with the tokenizer's
control-token ids, and its hypothesis is the generated part.
"""

import math
from collections import Counter

import numpy as np
import torch

from easynlp_tpu_torch.core.evaluator import Evaluator, eval_mode


def bleu4(hypothesis, reference):
    """Sentence BLEU-4 with +1 smoothing (tokens = lists of ids)."""
    if not hypothesis or not reference:
        return 0.0
    log_precision = 0.0
    for n in range(1, 5):
        h_ngrams = Counter(tuple(hypothesis[i:i + n])
                           for i in range(len(hypothesis) - n + 1))
        r_ngrams = Counter(tuple(reference[i:i + n])
                           for i in range(len(reference) - n + 1))
        overlap = sum((h_ngrams & r_ngrams).values())
        total = max(sum(h_ngrams.values()), 1)
        log_precision += math.log((overlap + 1.0) / (total + 1.0))
    bp = min(1.0, math.exp(1.0 - len(reference) / max(len(hypothesis), 1)))
    return bp * math.exp(log_precision / 4.0)


def rouge_l(hypothesis, reference):
    """ROUGE-L F1 through the longest common subsequence."""
    if not hypothesis or not reference:
        return 0.0
    m, n = len(hypothesis), len(reference)
    dp = np.zeros((m + 1, n + 1), np.int32)
    for i in range(m):
        for j in range(n):
            if hypothesis[i] == reference[j]:
                dp[i + 1, j + 1] = dp[i, j] + 1
            else:
                dp[i + 1, j + 1] = max(dp[i, j + 1], dp[i + 1, j])
    lcs = int(dp[m, n])
    if lcs == 0:
        return 0.0
    p, r = lcs / m, lcs / n
    return 2 * p * r / (p + r)


class SequenceGenerationEvaluator(Evaluator):
    def __init__(self, valid_dataset, max_decode_length=64, num_beams=1,
                 **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(valid_dataset, **kwargs)
        self.tokenizer = valid_dataset.tokenizer
        self.max_decode_length = max_decode_length
        self.num_beams = num_beams

    def evaluate(self, app):
        from easynlp_tpu_torch.appzoo.sequence_generation.predictor import (
            glm_special_ids)
        bleu_sum = rouge_sum = n = 0
        specials = set(self.tokenizer.all_special_ids)
        kw = glm_special_ids(self.tokenizer)
        with eval_mode(app.module):
            for batch in self.valid_loader:
                valid = batch.pop("_valid").astype(bool)
                src_mask = batch["attention_mask"]
                if "prefix_lengths" in batch:
                    t = batch["input_ids"].shape[1]
                    src_mask = (np.arange(t)[None, :]
                                < batch["prefix_lengths"][:, None] - 1
                                ).astype(np.int32)
                seqs = app.generate(
                    torch.from_numpy(batch["input_ids"]).to(app.device),
                    torch.from_numpy(src_mask).to(app.device),
                    max_length=self.max_decode_length,
                    num_beams=self.num_beams, **kw)
                seqs = seqs.cpu().numpy()[valid]
                labels = batch["labels"][valid]
                for hyp, ref in zip(seqs, labels):
                    if hasattr(app, "generated_tokens") \
                            and not app.config.is_encoder_decoder:
                        hyp = app.generated_tokens(hyp,
                                                   self.max_decode_length)
                    h = [int(t) for t in hyp if int(t) not in specials]
                    r = [int(t) for t in ref if t != -100
                         and int(t) not in specials]
                    bleu_sum += bleu4(h, r)
                    rouge_sum += rouge_l(h, r)
                    n += 1
        return [("bleu", bleu_sum / max(n, 1)),
                ("rouge_l", rouge_sum / max(n, 1))]
