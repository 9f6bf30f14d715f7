"""GLM block-infilling pretraining for the PyTorch port
(``app_name=language_modeling`` + ``enable_glm``): a GLM pretrained from
scratch on a plain-text TSV corpus.

The port's own copy of easynlp_tpu/appzoo/language_modeling/
glm_pretrain.py, giving the same examples for the same seed and epoch:
per example a corruption mode is drawn with Python's `random.Random`
seeded by (seed, epoch, index), so `set_epoch` gives fresh blanks every
epoch, reproducible across resumes:

- **bert** (prob ``bert_prob``, default 0.5): short spans of Poisson
  lengths (mean ``avg_block_length``) until ``bert_ratio`` (0.15) of the
  tokens are masked; each span a [MASK] in Part A and a ``[sop] span``
  block in Part B (`build_block_layout`);
- **gap_sentence** (prob ``gap_sentence_prob``, default 0): whole
  sentences, split on sentence-final punctuation, until
  ``gap_sentence_ratio`` of the tokens;
- **gpt** (the rest): one long blank of ``>= gpt_min_ratio * len``
  tokens, with prob ``gpt_infill_prob`` as the suffix layout
  ``src [gMASK] [sop] tgt`` (`build_gpt_suffix_layout`), else one span.

``labels[i]`` is the token position ``i`` predicts (IGNORE outside Part
B), ``position_ids`` collapse each span to its start, ``block_position_ids``
run 1..len+1 in each block, ``prefix_lengths`` is Part A's length. Every
example pads to ``max_seq_length``. The training forward attends with
GLM's block-infilling bias (per-row prefix lengths), on the plain path.
"""

import math

import numpy as np

import torch

from easynlp_tpu_torch.appzoo.language_modeling.evaluator import (
    LanguageModelingEvaluator,
    masked_nll,
)
from easynlp_tpu_torch.data.dataset import BaseDataset

IGNORE = -100

SENTENCE_END_CHARS = set(".?!;:。？！；…\n")


def poisson_block_weights(average_block_length=3, max_block_length=40):
    """Span-length distribution: Poisson pmf over 1..max_block_length-1
    (ref blocklm_utils.py:53)."""
    lam = float(average_block_length)
    return [math.exp(-lam) * lam ** i / math.factorial(i)
            for i in range(1, max_block_length)]


def sample_block_lengths(rng, n_tokens, ratio, weights):
    """Draw lengths until ``ratio * n_tokens`` tokens are covered
    (ref construct_blocks:336-341)."""
    lengths, covered = [], 0
    target = int(ratio * n_tokens)
    sides = list(range(1, len(weights) + 1))
    while covered < target:
        length = rng.choices(sides, weights=weights)[0]
        lengths.append(length)
        covered += length
    return lengths


def sample_spans(lengths, total, rng, offset=0):
    """Place non-overlapping spans (>=1 token between consecutive spans)
    uniformly in ``total`` tokens starting at ``offset``
    (ref sample_spans:102-114). Returns None when infeasible."""
    blank = total - sum(lengths)
    m = blank - len(lengths) + 1
    if m < 0:
        return None
    places = sorted(rng.randrange(m + 1) for _ in lengths)
    spans = []
    for place, length in zip(places, lengths):
        spans.append((offset + place, offset + place + length))
        offset += length + 1
    return spans


def build_block_layout(tokens, spans, mask_ids, sop_id, eop_id, rng,
                       shuffle_blocks=True, position_bias=0):
    """[Part A with one mask per span][shuffled ``[sop] span`` blocks]
    with 2D positions (ref make_block_data:172-268). ``mask_ids`` is one
    mask token per span (same order as ``spans``, which must be sorted).

    Returns (input_ids, labels, position_ids, block_position_ids, sep)."""
    n = len(tokens)
    ones = np.ones(n, np.int64)
    for start, end in spans:
        ones[start + 1:end] = 0
    pos = np.cumsum(ones) - 1 + position_bias  # span interiors collapse
    src_ids, src_pos, last = [], [], 0
    for (start, end), mask_id in zip(spans, mask_ids):
        src_ids += list(tokens[last:start]) + [mask_id]
        src_pos += list(pos[last:start]) + [int(pos[start])]
        last = end
    src_ids += list(tokens[last:])
    src_pos += list(pos[last:])
    sep = len(src_ids)
    order = list(range(len(spans)))
    if shuffle_blocks:
        rng.shuffle(order)
    tgt_ids, tgt_lbl, tgt_pos, tgt_blk = [], [], [], []
    for i in order:
        start, end = spans[i]
        span = list(tokens[start:end])
        tgt_ids += [sop_id] + span
        tgt_lbl += span + [eop_id]
        tgt_pos += [int(pos[start])] * (end - start + 1)
        tgt_blk += list(range(1, end - start + 2))
    ids = src_ids + tgt_ids
    labels = [IGNORE] * sep + tgt_lbl
    positions = src_pos + tgt_pos
    blocks = [0] * sep + tgt_blk
    return ids, labels, positions, blocks, sep


def build_gpt_suffix_layout(tokens, gen_len, gmask_id, sop_id):
    """Suffix generation: ``src [gMASK] [sop] tgt[:-1]`` predicting ``tgt``
    with loss from the [sop] position (ref construct_blocks:410-432).

    Returns (input_ids, labels, position_ids, block_position_ids, sep)."""
    division = len(tokens) - gen_len
    src, tgt = list(tokens[:division]), list(tokens[division:])
    ids = src + [gmask_id, sop_id] + tgt[:-1]
    labels = [IGNORE] * (division + 1) + tgt
    positions = list(range(division + 1)) + [division] * gen_len
    blocks = [0] * division + list(range(gen_len + 1))
    return ids, labels, positions, blocks, division + 1


def sentence_spans(tokens, is_sentence_end, offset=0):
    """Split ``tokens[offset:]`` into sentence (start, end) spans on
    sentence-final punctuation (ref construct_blocks:363-375)."""
    spans, last = [], offset
    for i in range(offset, len(tokens)):
        if is_sentence_end(int(tokens[i])):
            if last < i + 1:
                spans.append((last, i + 1))
            last = i + 1
    if last < len(tokens):
        spans.append((last, len(tokens)))
    return spans


class GLMPretrainDataset(BaseDataset):
    """Plain-text rows -> per-epoch randomly-blanked GLM pretraining
    examples with static ``max_seq_length`` shapes."""

    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None, seed=1234,
                 user_defined_parameters=None, **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label",
                  "is_training", "image_size", "second_sequence"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer
        self.max_seq_length = int(max_seq_length)
        self.first_sequence = first_sequence or "text"
        self.seed = int(udp.get("seed", seed))
        self.epoch = 0
        # reference CLI defaults (easynlp/utils/arguments.py:619-634)
        self.bert_prob = float(udp.get("bert_prob", 0.5))
        self.gap_sentence_prob = float(udp.get("gap_sentence_prob", 0.0))
        self.gpt_infill_prob = float(udp.get("gpt_infill_prob", 0.5))
        self.gpt_min_ratio = float(udp.get("gpt_min_ratio", 0.5))
        self.bert_ratio = float(udp.get("bert_ratio", 0.15))
        self.gap_sentence_ratio = float(udp.get("gap_sentence_ratio", 0.15))
        self.single_span_prob = float(udp.get("single_span_prob", 0.0))
        self.short_seq_prob = float(udp.get("short_seq_prob", 0.0))
        self.shuffle_blocks = bool(int(udp.get("shuffle_blocks", 1)))
        self.random_position = bool(int(udp.get("random_position", 0)))
        self.task_mask = bool(int(udp.get("task_mask", 0)))
        for unsupported in ("block_mask_prob", "context_mask_ratio",
                            "masked_lm", "sentinel_token"):
            if float(udp.get(unsupported, 0)):
                raise NotImplementedError(
                    "%s is not supported by the GLM pretraining collator "
                    "(nor by the JAX package's)" % unsupported)
        self.block_weights = poisson_block_weights(
            int(udp.get("avg_block_length", 3)),
            int(udp.get("max_block_length", 40)))
        mask_id = getattr(tokenizer, "mask_token_id", None)
        # with task_mask off every mode uses [MASK] (ref :63-66)
        self.mask_id = int(udp.get("mask_id", mask_id if mask_id is not None
                                   else 4))
        self.gmask_id = int(udp.get("gmask_id", getattr(
            tokenizer, "gmask_token_id", self.mask_id))) if self.task_mask \
            else self.mask_id
        self.smask_id = int(udp.get("smask_id", getattr(
            tokenizer, "smask_token_id", self.mask_id))) if self.task_mask \
            else self.mask_id
        self.sop_id = int(udp.get("sop_id", getattr(
            tokenizer, "sop_token_id", 1)))
        self.eop_id = int(udp.get("eop_id", getattr(
            tokenizer, "eop_token_id", 2)))
        self.pad_id = int(udp.get("pad_id",
                                  getattr(tokenizer, "pad_token_id", 0)))
        cls_id = getattr(tokenizer, "cls_token_id", None)
        self.cls_id = int(udp.get("cls_id",
                                  cls_id if cls_id is not None else 3))
        self._sent_end = None
        self._build_features()

    # -- tokenisation (once; corruption is per-epoch in __getitem__) --------
    def _build_features(self):
        texts = []
        for row in self.rows:
            r = self.parse_row(row)
            texts.append(str(r.get(self.first_sequence, r.get("text", ""))))
        # body budget: CLS occupies 1 slot and the gpt suffix layout grows
        # by 1 ([gMASK][sop] added, last target token dropped)
        enc = self.tokenizer(texts, max_length=self.max_seq_length)
        specials = set(int(i) for i in getattr(
            self.tokenizer, "all_special_ids", []) or [])
        specials.add(self.pad_id)
        bodies = []
        for ids in enc["input_ids"]:
            body = [int(t) for t in ids if int(t) not in specials]
            bodies.append(np.asarray(body[:self.max_seq_length - 2],
                                     np.int64))
        self.bodies = bodies

    def _is_sentence_end(self, token_id):
        if self._sent_end is None:
            table = {}
            get_vocab = getattr(self.tokenizer, "get_vocab", None)
            if get_vocab is not None:
                for tok, tid in get_vocab().items():
                    if any(c in SENTENCE_END_CHARS for c in str(tok)):
                        table[int(tid)] = True
            self._sent_end = table
        return self._sent_end.get(int(token_id), False)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.bodies)

    def _corrupt(self, body, rng):
        """One corrupted layout (unpadded). ``body`` has no special ids;
        the produced sequence carries [CLS] at 0 (protected from spans)."""
        n = len(body)
        if n < 4:  # degenerate row: predict the whole body as a suffix
            tokens = np.concatenate(([self.cls_id], body)).astype(np.int64)
            return build_gpt_suffix_layout(tokens, max(1, n), self.gmask_id,
                                           self.sop_id)
        if self.short_seq_prob and rng.random() < self.short_seq_prob:
            # ref split_samples:283-310 (simplified: one random window
            # instead of num_splits copies — static batch width)
            target = rng.randrange(32, self.max_seq_length - 1)
            if target < n:
                start = rng.randrange(0, n - target)
                body = body[start:start + target]
                n = len(body)
        tokens = np.concatenate(([self.cls_id], body)).astype(np.int64)
        total = len(tokens)
        single_span = rng.random() < self.single_span_prob
        rand = 0.0 if single_span else rng.random()
        budget = self.max_seq_length
        bias = 0
        if self.random_position:
            bias = rng.randrange(0, max(1, self.max_seq_length - total))

        if rand < self.bert_prob:
            if single_span:
                lengths = [rng.choices(
                    range(1, len(self.block_weights) + 1),
                    weights=self.block_weights)[0]]
            else:
                lengths = sample_block_lengths(rng, total, self.bert_ratio,
                                               self.block_weights)
            # trim for static width (each span grows the layout by 2) and
            # placement feasibility (>=1 gap between spans, CLS protected)
            lengths = [min(length, n) for length in lengths]
            while lengths and (total + 2 * len(lengths) > budget
                               or sum(lengths) + len(lengths) - 1 > n):
                lengths.pop()
            lengths = lengths or [1]
            rng.shuffle(lengths)
            spans = sample_spans(lengths, n, rng, offset=1)
            if spans is None:
                spans = [(1, 2)]
            return build_block_layout(
                tokens, spans, [self.mask_id] * len(spans), self.sop_id,
                self.eop_id, rng, self.shuffle_blocks, bias)

        if rand < self.bert_prob + self.gap_sentence_prob:
            sents = sentence_spans(tokens, self._is_sentence_end, offset=1)
            rng.shuffle(sents)
            spans, covered = [], 0
            for start, end in sents:
                if total + 2 * (len(spans) + 1) > budget:
                    break
                spans.append((start, end))
                covered += end - start
                if covered >= int(self.gap_sentence_ratio * total):
                    break
            spans = sorted(spans) or [(1, 2)]
            return build_block_layout(
                tokens, spans, [self.smask_id] * len(spans), self.sop_id,
                self.eop_id, rng, self.shuffle_blocks, bias)

        # gpt long blank (ref :402-440); per-example length draw
        # (the reference couples gen_len across its mode-uniform batch)
        lo = max(1, int(self.gpt_min_ratio * total))
        gen_len = rng.randint(min(lo, total - 2), total - 2)
        # suffix layout width = total + 1 <= budget always (body budget
        # reserves 2 slots); the single-span layout needs total + 2
        if rng.random() < self.gpt_infill_prob or total + 2 > budget:
            return build_gpt_suffix_layout(tokens, gen_len, self.gmask_id,
                                           self.sop_id)
        gen_len = min(gen_len, n - 1)  # span must fit after CLS with a gap
        start = rng.randrange(1, total - gen_len)
        spans = [(start, start + gen_len)]
        return build_block_layout(tokens, spans, [self.gmask_id],
                                  self.sop_id, self.eop_id, rng,
                                  shuffle_blocks=False, position_bias=bias)

    def __getitem__(self, idx):
        import random
        rng = random.Random(
            (self.seed + 1000003 * self.epoch) * len(self) + idx)
        ids, labels, positions, blocks, sep = self._corrupt(
            self.bodies[idx], rng)
        s = self.max_seq_length
        ids, labels = ids[:s], labels[:s]
        positions, blocks = positions[:s], blocks[:s]
        sep = min(sep, s)
        pad = s - len(ids)
        return {
            "input_ids": np.asarray(ids + [self.pad_id] * pad, np.int32),
            "attention_mask": np.asarray(
                [1] * len(ids) + [0] * pad, np.int32),
            "position_ids": np.asarray(positions + [0] * pad, np.int32),
            "block_position_ids": np.asarray(blocks + [0] * pad, np.int32),
            "labels": np.asarray(labels + [IGNORE] * pad, np.int32),
            "prefix_lengths": np.int32(sep),
        }

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class GLMPretrainEvaluator(LanguageModelingEvaluator):
    """Blank-infilling perplexity and accuracy over the GLM `labels`
    layout (the JAX GLMPretrainEvaluator): every position whose label is
    not IGNORE, of the real rows, reduced on the device by
    language_modeling/evaluator.py's masked_nll; returns [("accuracy",
    acc), ("perplexity", -ppl)]."""

    def evaluate(self, app):
        total_nll, total_correct, total_count = 0.0, 0, 0
        for batch in self.valid_loader:
            valid = batch.pop("_valid").astype(bool)
            labels = np.where(valid[:, None], batch["labels"], IGNORE)
            keep = labels != IGNORE
            if not keep.any():
                continue
            logits = self.forward(app, batch)["logits"]
            nll, hit = masked_nll(
                logits, torch.from_numpy(keep).to(logits.device),
                torch.from_numpy(labels).to(logits.device))
            total_nll += float(nll.cpu().numpy().sum())
            total_correct += int(hit.sum())
            total_count += int(keep.sum())
        ppl = float(np.exp(total_nll / max(total_count, 1)))
        acc = total_correct / max(total_count, 1)
        return [("accuracy", acc), ("perplexity", -ppl)]
