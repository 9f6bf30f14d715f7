"""MLM dataset with whole-word masking for the PyTorch port (its own copy of
easynlp_tpu/appzoo/language_modeling/data.py, giving the same arrays bit
for bit).

The table is tokenised once. Each row is masked when it is fetched, from a
RandomState seeded by (seed + 1000003 * epoch + row) mod 2^31, so every
epoch masks anew (dynamic masking; the DataLoader's set_epoch passes the
epoch on) and the masks do not depend on the batch or the thread that
fetches the row. Each thread reseeds one RandomState of its own, which
gives the stream a new RandomState(seed) gives without drawing the OS
entropy that construction draws first (most of a row's masking time); the
maskable positions and words of each row, which no epoch changes, are
found once; the chosen words are selected through a table over the row's
word ids. Continuation pieces ('##x') share their word's group,
15% of a row's groups are selected, and a selected token becomes [MASK]
(80%), a random id (10%) or stays (10%); `label_ids` holds the original
token where selected, -100 elsewhere. Special and pad tokens are never
selected.
"""

import threading

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset

IGNORE = -100


class LanguageModelingDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None,
                 mask_probability=0.15, whole_word_masking=True, seed=1234,
                 **kwargs):
        for key in ("label_name", "label_enumerate_values", "multi_label"):
            kwargs.pop(key, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence or "text"
        self.mask_probability = mask_probability
        self.whole_word_masking = whole_word_masking
        self.seed = seed
        self.epoch = 0
        self._local = threading.local()
        self._build_features()

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _build_features(self):
        texts = []
        for row in self.rows:
            r = self.parse_row(row)
            texts.append(str(r.get(self.first_sequence, r.get("text", ""))))
        enc = self.tokenizer(texts, max_length=self.max_seq_length)
        self.base = {k: np.asarray(v, np.int32) for k, v in enc.items()}
        ids = self.base["input_ids"]
        vocab_inv = {i: t for t, i in self.tokenizer.get_vocab().items()}
        groups = np.zeros_like(ids)
        for r in range(ids.shape[0]):
            gid = 0
            for c in range(ids.shape[1]):
                tok = vocab_inv.get(int(ids[r, c]), "")
                if not (self.whole_word_masking and tok.startswith("##")):
                    gid += 1
                groups[r, c] = gid
        self.groups = groups
        self.special_mask = np.isin(
            ids, np.asarray(self.tokenizer.all_special_ids))
        self.maskable = ~self.special_mask & (ids != self.tokenizer.pad_token_id)
        self.maskable_groups = [np.unique(g[m])
                                for g, m in zip(groups, self.maskable)]
        self._mask_id = self.tokenizer.mask_token_id
        self._vocab_size = self.tokenizer.vocab_size

    def __len__(self):
        return self.base["input_ids"].shape[0]

    def _rng(self, seed):
        """This thread's RandomState, reseeded."""
        rng = getattr(self._local, "rng", None)
        if rng is None:
            rng = self._local.rng = np.random.RandomState()
        rng.seed(seed)
        return rng

    def __getitem__(self, idx):
        rng = self._rng((self.seed + 1000003 * self.epoch + idx) % (2 ** 31))
        ids = self.base["input_ids"][idx].copy()
        labels = np.full_like(ids, IGNORE)
        unique_groups = self.maskable_groups[idx]
        if len(unique_groups):
            groups = self.groups[idx]
            chosen = unique_groups[
                rng.rand(len(unique_groups)) < self.mask_probability]
            hit = np.zeros(groups[-1] + 1, bool)
            hit[chosen] = True
            sel = hit[groups] & self.maskable[idx]
            labels[sel] = ids[sel]
            roll = rng.rand(ids.shape[0])
            do_mask = sel & (roll < 0.8)
            do_rand = sel & (roll >= 0.8) & (roll < 0.9)
            ids[do_mask] = self._mask_id
            ids[do_rand] = rng.randint(0, self._vocab_size, do_rand.sum())
        return {"input_ids": ids,
                "attention_mask": self.base["attention_mask"][idx],
                "token_type_ids": self.base["token_type_ids"][idx],
                "label_ids": labels}
