"""Generation predictor for the PyTorch port: source text -> generated text.

Counterpart of easynlp_tpu/appzoo/sequence_generation/predictor.py, with the
same user_defined_parameters contract (max_encoder_length,
max_decoder_length, min_decoder_length, no_repeat_ngram_size, num_beams,
num_beam_groups, diversity_penalty, num_return_sequences) and the same
output columns: `generated_ids` (the whole token buffer, space-separated;
for beams the best one), `predictions` (the best text) and `beams` (the
returned beams' texts joined by "||"). The buffer is GPT-2's prompt, left-
padded to the batch width, then max_decoder_length generated slots; or
BART's decoder buffer of max_decoder_length slots, the decoder start token
first, as the JAX app writes both.

One difference: the text columns decode only real tokens (ROADMAP C9).
GPT-2: the prompt's own tokens, then the generated ones up to and including
the first EOS. BART: the tokens after the start column, up to and including
the first EOS; BART's start token is its EOS (both id 2), so the cut never
looks at the start column. skip_special_tokens drops EOS where the
tokenizer knows it as special. The JAX predictor decodes the whole buffer,
so each pad and each slot after EOS (GPT-2's pad id 0 is "!") and BART's
start token come out as text. `generated_ids` stays as JAX writes it.
speculative_decoding and kv_cache_dtype are ROADMAP A16.
"""

import time

import numpy as np

from easynlp_tpu_torch.core.predictor import Predictor
from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for


class SequenceGenerationPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 sequence_length=128, batch_size=8, max_decode_length=None,
                 num_beams=None, user_defined_parameters=None, **_):
        udp = user_defined_parameters or {}
        for key in ("speculative_decoding", "kv_cache_dtype"):
            if udp.get(key):
                raise NotImplementedError(
                    "%s=%s is not ported yet (ROADMAP A16)" % (key, udp[key]))
        self.tokenizer = tokenizer_for(model_dir)
        self.first_sequence = first_sequence
        self.sequence_length = int(udp.get("max_encoder_length",
                                           sequence_length))
        self.max_decode_length = int(
            max_decode_length if max_decode_length is not None
            else udp.get("max_decoder_length", 64))
        self.min_decode_length = int(udp.get("min_decoder_length", 0))
        self.num_beams = int(num_beams if num_beams is not None
                             else udp.get("num_beams", 1))
        self.no_repeat_ngram_size = int(udp.get("no_repeat_ngram_size", 0))
        self.num_beam_groups = int(udp.get("num_beam_groups", 1)) or 1
        # None = unset (1.0 under grouped beams); an explicit 0.0 stays 0.0
        dp = udp.get("diversity_penalty")
        self.diversity_penalty = None if dp is None else float(dp)
        self.num_return_sequences = min(
            int(udp.get("num_return_sequences", 1)), max(self.num_beams, 1))
        self.app = app
        self.batch_size = batch_size
        self.batch_seconds = []

    def _generate_kwargs(self):
        kw = {"max_length": self.max_decode_length,
              "num_beams": self.num_beams}
        if self.min_decode_length:
            kw["min_length"] = self.min_decode_length
        if self.no_repeat_ngram_size:
            kw["no_repeat_ngram_size"] = self.no_repeat_ngram_size
        if self.num_beam_groups > 1:
            kw["num_beam_groups"] = self.num_beam_groups
            kw["diversity_penalty"] = (1.0 if self.diversity_penalty is None
                                       else self.diversity_penalty)
        if self.num_return_sequences > 1 and self.num_beams > 1:
            kw["num_return_sequences"] = self.num_return_sequences
        return kw

    def preprocess(self, in_data):
        enc = self.tokenizer([str(t) for t in in_data[self.first_sequence]],
                             max_length=self.sequence_length)
        out = dict(in_data)
        out.update({k: np.asarray(v, np.int32) for k, v in enc.items()})
        return out

    def predict(self, in_data):
        """Generates batch by batch; a short last batch is padded to
        batch_size with copies of its last row (as the JAX predictor does
        to keep one compiled shape), and the copies are dropped.
        `batch_seconds` records each batch's host-clock time, generated
        tokens back on the host."""
        n = len(in_data["input_ids"])
        result = dict(in_data)
        if n == 0:
            result["generated_ids"] = np.zeros((0, 1), np.int32)
            return result
        bs = self.batch_size
        kw = self._generate_kwargs()
        outs = []
        for start in range(0, n, bs):
            ids = in_data["input_ids"][start:start + bs]
            mask = in_data["attention_mask"][start:start + bs]
            real = len(ids)
            if real < bs:
                ids = np.concatenate([ids, np.repeat(ids[-1:], bs - real, 0)])
                mask = np.concatenate([mask,
                                       np.repeat(mask[-1:], bs - real, 0)])
            t0 = time.perf_counter()
            seqs = self.app.generate(ids, mask, **kw).cpu().numpy()
            self.batch_seconds.append(time.perf_counter() - t0)
            outs.append(seqs[:real])
        result["generated_ids"] = np.concatenate(outs)
        return result

    def _text(self, row, prompt_len):
        """The decoded real tokens of one buffer row (see the module
        docstring): for GPT-2, whose prompt (left-padded to the batch width)
        holds prompt_len real tokens, the prompt's tokens and the generated
        ones; for BART the tokens after the start column. Generated tokens
        are cut after the first EOS."""
        if self.app.config.is_encoder_decoder:
            p, prompt = 1, []
        else:
            p = len(row) - self.max_decode_length
            prompt = list(row[p - prompt_len:p])
        generated = list(row[p:])
        eos = self.app.config.eos_token_id
        if eos in generated:
            generated = generated[:generated.index(eos) + 1]
        return self.tokenizer.decode(prompt + generated,
                                     skip_special_tokens=True)

    def postprocess(self, result):
        result = dict(result)
        gen = np.asarray(result["generated_ids"])
        prompt_lens = np.asarray(result["attention_mask"]).sum(axis=1)
        if gen.ndim == 3:
            # [B, N, T] beam lists (reference predictor.py:176-179:
            # predictions = the best beam, beams = the top N joined by "||")
            texts = [[self._text(b, n) for b in row]
                     for row, n in zip(gen, prompt_lens)]
            result["predictions"] = [row[0] for row in texts]
            result["beams"] = ["||".join(row) for row in texts]
            result["generated_ids"] = [" ".join(str(x) for x in row[0])
                                       for row in gen]
            return result
        texts = [self._text(row, n) for row, n in zip(gen, prompt_lens)]
        result["predictions"] = texts
        result["beams"] = texts
        result["generated_ids"] = [" ".join(str(x) for x in row)
                                   for row in gen]
        return result
