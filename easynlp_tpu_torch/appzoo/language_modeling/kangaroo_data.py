"""Kangaroo pretraining dataset for the PyTorch port (its own copy of
easynlp_tpu/appzoo/language_modeling/kangaroo_data.py, giving the same
arrays bit for bit): entity-tree linking, entity-aware masking,
contrastive samples, Poincaré concept embeddings.

user_defined_parameters: `entity_file` (a CSV of index, main_name and
'|'-joined name_list), `samples_file` ({entity_id: {level_k: [{'tokens',
'position_id'}]}} npy; the contrastive sample sentences) and
`concept_emb_file` ({entity_id: vector} npy, e.g. utils/poincare.py's);
`ent_num` (3), `sample_num` (4), `entity_gap` (5), `concept_size` (100),
`mlm_mask_prop` (0.15). The entity names become a char-level token-id trie;
the sample and concept tables are dense, row 0 = "no entity". Per row:
longest-match linking with an `entity_gap` exclusion zone, up to ent_num
entities; then whole entities masked and token MLM away from them, drawn
from a Python random.Random seeded by (seed + 1000003 * epoch + row) mod
2^31, in the JAX package's order, so the masks are the same.
"""

import csv
import random

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset
from easynlp_tpu_torch.data.entity_trie import TokenTrie

IGNORE = -100


class KangarooPretrainDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None,
                 user_defined_parameters=None, mlm_mask_prop=0.15, seed=1234,
                 **kwargs):
        for k in ("label_name", "label_enumerate_values", "multi_label",
                  "is_training"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence or "text"
        self.mlm_mask_prop = float(udp.get("mlm_mask_prop", mlm_mask_prop))
        self.ent_num = int(udp.get("ent_num", 3))
        self.sample_num = int(udp.get("sample_num", 4))
        self.entity_gap = int(udp.get("entity_gap", 5))
        self.concept_size = int(udp.get("concept_size", 100))
        self.seed = seed
        self.epoch = 0

        vocab = self.tokenizer.get_vocab()
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.mask_id = vocab["[MASK]"]
        self.pad_id = vocab.get("[PAD]", 0)
        self.vocab_size = len(vocab)

        entity_file = udp.get("entity_file", "")
        samples_file = udp.get("samples_file", "")
        concept_emb_file = udp.get("concept_emb_file", "")
        if not entity_file:
            raise ValueError("Kangaroo needs entity_file in "
                             "user_defined_parameters")
        self.entity_tree, self.tokenid2entityid = \
            self._create_entity_tree(entity_file)
        self.tokenidVec, self.positionidVec = \
            self._load_contrastive_samples(samples_file)
        self.conceptEmbVec = self._load_concept_emb(concept_emb_file)

        self._texts = []
        for row in self.rows:
            r = self.parse_row(row)
            self._texts.append(str(r.get(self.first_sequence,
                                         r.get("text", ""))))

    # -- knowledge tables -----------------------------------------------------

    def _create_entity_tree(self, entity_file):
        """Entity CSV (index, main_name, name_list '|'-joined) → trie over
        char-level token ids."""
        full_name_to_id = {}
        with open(entity_file, newline="") as f:
            for rec in csv.DictReader(f):
                names = str(rec.get("name_list", "") or "").split("|")
                main = rec.get("main_name")
                if main and main not in names:
                    names.append(main)
                idx = int(rec["index"])
                for name in names:
                    if name:
                        full_name_to_id[name] = idx
        tree = TokenTrie()
        tokenid2entityid = {}
        for entity, idx in full_name_to_id.items():
            token_ids = self.tokenizer.convert_tokens_to_ids(list(entity))
            tree.add_word(token_ids)
            tokenid2entityid[tuple(token_ids)] = idx
        return tree, tokenid2entityid

    def _load_contrastive_samples(self, samples_file, max_level=None):
        """samples npy: {entity_id: {level_k: [{'tokens', 'position_id'}]}}
        → dense [N+2, sample_num, S] token/position tables; row 0 stays zero
        for 'no entity'."""
        max_level = max_level or self.sample_num
        s = self.max_seq_length
        if not samples_file:
            return (np.zeros((2, max_level, s), np.int32),
                    np.zeros((2, max_level, s), np.int32))
        samples = np.load(samples_file, allow_pickle=True).item()
        max_index = int(np.max(list(samples.keys())))
        tok = np.zeros((max_index + 2, max_level, s), np.int32)
        pos = np.zeros((max_index + 2, max_level, s), np.int32)
        for ind, levels in samples.items():
            for li in range(1, max_level + 1):
                level = "level_%d" % li
                if not levels.get(level):
                    level = "level_2"
                if not levels.get(level):
                    continue
                entry = levels[level][0]
                ids = self.tokenizer.convert_tokens_to_ids(
                    list(entry["tokens"]))[:s]
                pids = list(entry["position_id"])[:s]
                tok[ind + 1, li - 1, :len(ids)] = ids
                pos[ind + 1, li - 1, :len(pids)] = pids
        return tok, pos

    def _load_concept_emb(self, emb_file):
        """{entity_id: vector} npy → dense [N+2, dim]."""
        if not emb_file:
            return np.zeros((2, self.concept_size), np.float32)
        entity2emb = np.load(emb_file, allow_pickle=True).item()
        max_index = int(np.max([int(k) for k in entity2emb.keys()]))
        out = np.zeros((max_index + 2, self.concept_size), np.float32)
        for ind, vec in entity2emb.items():
            out[int(ind) + 1, :len(vec)] = np.asarray(vec, np.float32)
        return out

    # -- per-row processing ------------------------------------------------

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self._texts)

    def _link_entities(self, token_ids):
        """Longest-match linking with the entity_gap exclusion. Returns
        (entity_ids [ent_num], entities_position [S'], entity_pos_true
        [(h, t)...])."""
        entity_pos = []
        i = 0
        while i < len(token_ids):
            ends = self.entity_tree.search(token_ids, i)
            if not ends:
                i += 1
                continue
            j = ends[-1]
            entity_pos.append((i, j))
            i = j + 1

        entities = [IGNORE] * len(token_ids)
        entities_position = [0] * len(token_ids)
        entity_index = 0
        entity_pos_true = []
        entity_id_list = []
        for (h, t) in entity_pos:
            close = False
            for d in range(1, self.entity_gap + 1):
                if h - d >= 0 and entities[h - d] != IGNORE:
                    close = True
            if close:
                continue
            ent_id = self.tokenid2entityid.get(tuple(token_ids[h:t]))
            if ent_id is None:
                continue
            entity_index += 1
            entity_pos_true.append((h, t))
            entity_id_list.append(ent_id)
            for k in range(h, t):
                entities[k] = ent_id
                entities_position[k] = entity_index
            if entity_index == self.ent_num:
                break
        while len(entity_id_list) < self.ent_num:
            entity_id_list.append(-1)
        return entity_id_list, entities_position, entity_pos_true

    def _create_mask(self, token_ids, entity_pos_true, rng):
        """Entity masking + token MLM away from entities."""
        entity_pos_true = list(entity_pos_true)
        labels = [IGNORE] * len(token_ids)
        masked = list(token_ids)
        input_len = len(token_ids)
        ent_len = sum(j - i for (i, j) in entity_pos_true)
        while entity_pos_true and ent_len / input_len > 0.1:
            del entity_pos_true[rng.randint(0, len(entity_pos_true) - 1)]
            ent_len = sum(j - i for (i, j) in entity_pos_true)
        denom = input_len - 7 * len(entity_pos_true)
        token_prob = max(self.mlm_mask_prop - ent_len / input_len, 0.0) \
            * input_len / max(denom, 1)

        flag = [1] * input_len
        for (h, t) in entity_pos_true:
            labels[h:t] = token_ids[h:t]
            masked[h:t] = [self.mask_id] * (t - h)
            s = max(h - self.entity_gap, 0)
            e = min(t + self.entity_gap, input_len)
            flag[s:e] = [0] * (e - s)

        for ind in range(input_len):
            if flag[ind] == 0 or rng.random() > token_prob:
                continue
            labels[ind] = token_ids[ind]
            r = rng.random()
            if r < 0.8:
                masked[ind] = self.mask_id
            elif r < 0.9:
                masked[ind] = rng.randrange(self.vocab_size)
        return masked, labels

    def __getitem__(self, idx):
        rng = random.Random((self.seed + 1000003 * self.epoch + idx)
                            % (2 ** 31))
        text = self._texts[idx]
        token_ids = self.tokenizer.convert_tokens_to_ids(list(text))
        token_ids = token_ids[:self.max_seq_length - 2]

        entity_ids, entities_position, entity_pos_true = \
            self._link_entities(token_ids)
        masked, labels = self._create_mask(token_ids, entity_pos_true, rng)

        s = self.max_seq_length
        masked = [self.cls_id] + masked + [self.sep_id]
        labels = [IGNORE] + labels + [IGNORE]
        entities_position = [0] + entities_position + [0]
        mask = [1] * len(masked)
        pad = s - len(masked)
        masked += [self.pad_id] * pad
        labels += [IGNORE] * pad
        entities_position += [0] * pad
        mask += [0] * pad

        ent_index = np.asarray(entity_ids, np.int64) + 1  # 0 = no entity
        ent_index = np.clip(ent_index, 0, len(self.tokenidVec) - 1)
        sample_token_id = self.tokenidVec[ent_index]      # [ent_num, K, S]
        sample_position_id = self.positionidVec[ent_index]
        concept_index = np.clip(ent_index, 0, len(self.conceptEmbVec) - 1)
        concept_emb = self.conceptEmbVec[concept_index]   # [ent_num, C]

        ep = np.asarray(entities_position, np.int32)
        return {
            "input_ids": np.asarray(masked, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "label_ids": np.asarray(labels, np.int32),
            "entities_position": ep,
            "ent_mask": (ep != 0).astype(np.int32),
            "sample_token_id": sample_token_id.astype(np.int32),
            "sample_position_id": sample_position_id.astype(np.int32),
            "sample_mask": (sample_token_id != 0).astype(np.int32),
            "concept_emb": concept_emb.astype(np.float32),
        }

    def batch_fn(self, examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
