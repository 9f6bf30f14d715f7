"""DKPLM pretraining dataset for the PyTorch port (its own copy of
easynlp_tpu/appzoo/language_modeling/dkplm_data.py, giving the same arrays
bit for bit).

Rows are dict literals {'text' (with [ENT]...[ENT] spans), 'relation_id',
'replced_entity_id'}. Per row the [ENT] markers are stripped and the spans'
token positions kept; the TransE pseudo-entity embedding entity_emb[id] +
rel_emb[id] is written over each span (`insert_know_emb`, with
`insert_know_position_mask`), the decode-knowledge labels are the span's
original tokens, and the MLM masks 15% of the other real tokens (80%
[MASK], 10% a random id, 10% kept). The embedding tables are the
comma-separated text files user_defined_parameters `entity_emb_file` and
`rel_emb_file` name. Each row is masked when it is fetched, from a
RandomState seeded by (seed + 1000003 * epoch + row) mod 2^31, as in the
JAX package; each thread reseeds one RandomState of its own, which draws
the same stream without the OS entropy a new RandomState draws.
"""

import ast
import threading

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset

IGNORE = -100


def load_emb_table(path):
    """A comma-separated text table, one row a line, as f32 [N, D]."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) for x in line.split(",")])
    return np.asarray(rows, np.float32)


class DKPLMPretrainDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None,
                 user_defined_parameters=None, mlm_mask_prop=0.15, seed=1234,
                 **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label",
                  "is_training"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        entity_emb_file = udp.get("entity_emb_file", "")
        rel_emb_file = udp.get("rel_emb_file", "")
        if not entity_emb_file or not rel_emb_file:
            raise ValueError("DKPLM needs entity_emb_file and rel_emb_file "
                             "in user_defined_parameters")
        self.entity_emb = load_emb_table(entity_emb_file)
        self.rel_emb = load_emb_table(rel_emb_file)
        if self.entity_emb.shape[1] != self.rel_emb.shape[1]:
            raise ValueError("entity_emb_file is %d wide, rel_emb_file %d"
                             % (self.entity_emb.shape[1],
                                self.rel_emb.shape[1]))
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.mlm_mask_prop = float(udp.get("mlm_mask_prop", mlm_mask_prop))
        self.seed = seed
        self.epoch = 0
        self._local = threading.local()
        vocab = tokenizer.get_vocab()
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.mask_id = vocab["[MASK]"]
        self.pad_id = vocab.get("[PAD]", 0)
        self.vocab_size = len(vocab)
        self.special_ids = np.asarray(sorted(set(tokenizer.all_special_ids)))

    @property
    def knowledge_emb_size(self):
        return self.entity_emb.shape[1]

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _parse_dkplm_row(self, row):
        """'[ENT]'-delimited text -> (tokens, [(start, end)...] in token
        coordinates, relation ids, entity ids)."""
        rec = ast.literal_eval(row if not self.schema
                               else self.parse_row(row).get("text", row))
        text = rec["text"]
        rel = rec.get("relation_id", 0)
        ent = rec.get("replced_entity_id", rec.get("replaced_entity_id", 0))
        rels = rel if isinstance(rel, (list, tuple)) else [rel]
        ents = ent if isinstance(ent, (list, tuple)) else [ent]
        tokens, spans = [], []
        for i, seg in enumerate(text.split("[ENT]")):
            seg_tokens = self.tokenizer.tokenize(seg)
            if i % 2 == 1:  # inside an [ENT]...[ENT] span
                spans.append((len(tokens), len(tokens) + len(seg_tokens)))
            tokens.extend(seg_tokens)
        return tokens, spans, rels, ents

    def __len__(self):
        return len(self.rows)

    def _rng(self, seed):
        """This thread's RandomState, reseeded."""
        rng = getattr(self._local, "rng", None)
        if rng is None:
            rng = self._local.rng = np.random.RandomState()
        rng.seed(seed)
        return rng

    def __getitem__(self, idx):
        rng = self._rng((self.seed + 1000003 * self.epoch + idx) % (2 ** 31))
        tokens, spans, rels, ents = self._parse_dkplm_row(self.rows[idx])
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        ids = ids[:self.max_seq_length - 2]
        s = self.max_seq_length
        full = [self.cls_id] + ids + [self.sep_id]
        n = len(full)
        input_ids = np.full((s,), self.pad_id, np.int32)
        input_ids[:n] = full
        attention_mask = np.zeros((s,), np.int32)
        attention_mask[:n] = 1

        know_mask = np.zeros((s,), np.int32)
        know_emb = np.zeros((s, self.knowledge_emb_size), np.float32)
        know_labels = np.full((s,), IGNORE, np.int32)
        for span, rel, ent in zip(spans, rels, ents):
            start = span[0] + 1  # +1 for [CLS]
            end = min(span[1] + 1, n - 1)
            if start >= end:
                continue
            know_mask[start:end] = 1
            know_labels[start:end] = input_ids[start:end]
            # TransE pseudo entity: entity + relation
            know_emb[start:end] = \
                self.entity_emb[int(ent) % len(self.entity_emb)] + \
                self.rel_emb[int(rel) % len(self.rel_emb)]

        # MLM masking away from the knowledge spans (they have their loss)
        labels = np.full((s,), IGNORE, np.int32)
        maskable = attention_mask.astype(bool) & (know_mask == 0) & \
            ~np.isin(input_ids, self.special_ids)
        sel = maskable & (rng.rand(s) < self.mlm_mask_prop)
        labels[sel] = input_ids[sel]
        r = rng.rand(s)
        out_ids = np.where(sel & (r < 0.8), self.mask_id, input_ids)
        out_ids = np.where(sel & (r >= 0.8) & (r < 0.9),
                           rng.randint(0, self.vocab_size, s), out_ids)

        return {"input_ids": out_ids.astype(np.int32),
                "attention_mask": attention_mask,
                "token_type_ids": np.zeros((s,), np.int32),
                "label_ids": labels,
                "insert_know_position_mask": know_mask,
                "insert_know_emb": know_emb,
                "insert_know_labels": know_labels}

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
