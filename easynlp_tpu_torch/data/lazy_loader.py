"""Lazy / streaming row access for pretraining-scale corpora (the PyTorch
port's own copy of easynlp_tpu/data/lazy_loader.py).

Capability parity: reference easynlp/modelzoo/mg_utils/lazy_loader.py (mmap-
backed lazy array of text rows with an offset index) and the reference
datasets' per-__getitem__ tokenisation. The round-1 data layer read whole
files with readlines() and featurised everything at construction — fine for
finetuning TSVs, a wall for MLM-pretraining corpora. LazyRows keeps only a
line-offset index in RAM (8 bytes/row) and decodes rows on demand from the
mmap; StreamingLanguageModelingDataset tokenises per item so host RAM stays
O(batch), with the C++ fast tokenizer on the hot path."""

import mmap

import numpy as np


class LazyRows:
    """List-like view over the non-empty lines of a file, mmap-backed.

    Supports len/int-index/slice (slices return index views, nothing is
    materialised) — exactly the surface BaseDataset needs for
    skip_first_line and multi-host row slicing."""

    def __init__(self, path, _parent=None, _index=None):
        if _parent is not None:
            self._mm = _parent._mm
            self._f = None
            self._offsets = _parent._offsets
            self._lengths = _parent._lengths
            self._index = _index
            return
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ) \
            if self._size(path) else None
        offsets, lengths = [], []
        pos = 0
        if self._mm is not None:
            find, size = self._mm.find, len(self._mm)
            while pos < size:
                nl = find(b"\n", pos)
                end = nl if nl != -1 else size
                # skip blank lines like the eager reader
                if self._mm[pos:end].strip():
                    offsets.append(pos)
                    lengths.append(end - pos)
                pos = end + 1
                if nl == -1:
                    break
        self._offsets = np.asarray(offsets, np.int64)
        self._lengths = np.asarray(lengths, np.int64)
        self._index = None

    @staticmethod
    def _size(path):
        import os
        return os.path.getsize(path)

    def _map(self, i):
        return int(self._index[i]) if self._index is not None else i

    def __len__(self):
        return len(self._index) if self._index is not None \
            else len(self._offsets)

    def __getitem__(self, key):
        if isinstance(key, slice):
            base = np.arange(len(self))[key]
            idx = self._index[base] if self._index is not None else base
            return LazyRows(None, _parent=self, _index=idx)
        i = self._map(int(key))
        off = int(self._offsets[i])
        raw = self._mm[off:off + int(self._lengths[i])]
        return raw.decode("utf-8", errors="replace").rstrip("\r\n")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._f is not None:
            if self._mm is not None:
                self._mm.close()
            self._f.close()


class StreamingLanguageModelingDataset:
    """MLM pretraining over a corpus too large to featurise up front:
    rows stay on disk (LazyRows), tokenisation+masking happen per item
    (deterministic in (seed, epoch, idx) — same dynamic-masking semantics as
    LanguageModelingDataset)."""

    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None,
                 mask_probability=0.15, seed=1234, process_index=0,
                 num_processes=1, **kwargs):
        from easynlp_tpu_torch.utils import parse_row_by_schema, parse_schema
        self.rows = LazyRows(data_file)
        if num_processes > 1:
            self.rows = self.rows[process_index::num_processes]
        self.schema = parse_schema(input_schema) if input_schema else None
        self._parse = parse_row_by_schema
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence or "text"
        self.mask_probability = mask_probability
        self.seed = seed
        self.epoch = 0
        self.label_enumerate_values = []
        vocab = tokenizer.get_vocab()
        self.mask_id = vocab["[MASK]"]
        self.special_ids = set(tokenizer.all_special_ids)
        self.vocab_size = len(vocab)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        rng = np.random.RandomState(
            (self.seed + 1000003 * self.epoch + idx) % (2 ** 31))
        row = self.rows[idx]
        text = self._parse(row, self.schema)[self.first_sequence] \
            if self.schema else row
        enc = self.tokenizer([str(text)], max_length=self.max_seq_length)
        ids = np.asarray(enc["input_ids"][0], np.int32)
        mask = np.asarray(enc["attention_mask"][0], np.int32)
        labels = np.full_like(ids, -100)
        maskable = mask.astype(bool) & ~np.isin(
            ids, np.asarray(sorted(self.special_ids)))
        sel = maskable & (rng.rand(len(ids)) < self.mask_probability)
        labels[sel] = ids[sel]
        r = rng.rand(len(ids))
        ids = np.where(sel & (r < 0.8), self.mask_id, ids)
        ids = np.where(sel & (r >= 0.8) & (r < 0.9),
                       rng.randint(0, self.vocab_size, len(ids)), ids)
        return {"input_ids": ids.astype(np.int32),
                "attention_mask": mask,
                "token_type_ids": np.zeros_like(ids),
                "label_ids": labels.astype(np.int32)}

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
