"""The knowledge models' data in the PyTorch port against the JAX package,
on the CPU: DKPLMPretrainDataset and KangarooPretrainDataset give the JAX
datasets' arrays bit for bit at epochs 0 and 1 (the masks are drawn anew
each epoch), TokenTrie gives the JAX trie's match ends, and
PoincareEmbedding.train the JAX copy's embedding bit for bit from one
seed. Also the fixtures the knowledge CLI tests share: a WordPiece
vocabulary with CJK characters (Kangaroo links entities character by
character), the DKPLM entity and relation tables and rows, and the
Kangaroo entity CSV, contrastive samples and Poincaré concept table, all
written from numpy seeds.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import FILLER, NEG_WORDS, POS_WORDS  # noqa: E402

CJK = [chr(0x4e00 + 7 * i) for i in range(40)]
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, max_position_embeddings=64,
            type_vocab_size=2, layer_norm_eps=1e-12, initializer_range=0.02,
            hidden_act="gelu", pad_token_id=0)
# DKPLM's tables and Kangaroo's knowledge widths
KG_DIM = 8
N_ENTITIES, N_RELATIONS = 12, 5
KANGAROO_UDP = dict(ent_num=2, sample_num=3, entity_gap=2, concept_size=5)
KANGAROO_CONFIG = dict(layer_types=["sim", "norm", "mix"], ent_size=12,
                       ent_heads=4, concept_size=5, ent_num=2, sample_num=3)


def write_vocab(path):
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + CJK
    tokens += sorted(set(POS_WORDS + NEG_WORDS + FILLER))
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    tokens += [c for c in "abcdefghijklmnopqrstuvwxyz" if c not in tokens]
    with open(path, "w") as f:
        f.write("\n".join(tokens) + "\n")
    return len(tokens)


def make_knowledge_dir(model_dir, model_type="bert", **extra):
    """vocab.txt and config.json (TINY widths, the vocabulary's size);
    returns the config dict."""
    os.makedirs(model_dir, exist_ok=True)
    config = dict(TINY, model_type=model_type, **extra)
    config["vocab_size"] = write_vocab(os.path.join(model_dir, "vocab.txt"))
    if model_type == "kangaroo":
        config["num_hidden_layers"] = 3
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    return config


def write_dkplm_tables(base, seed=0):
    """entity and relation embedding tables, comma-separated text."""
    rng = np.random.RandomState(seed)
    paths = []
    for name, n in (("entity_emb.txt", N_ENTITIES),
                    ("rel_emb.txt", N_RELATIONS)):
        paths.append(os.path.join(base, name))
        with open(paths[-1], "w") as f:
            for row in rng.standard_normal((n, KG_DIM)):
                f.write(",".join("%.6f" % x for x in row) + "\n")
    return paths


def write_dkplm_rows(path, n, seed):
    """id<TAB>dict literal: text with one or two [ENT]...[ENT] spans and
    their relation and entity ids (a list for two spans)."""
    rng = np.random.RandomState(seed)
    words = FILLER + POS_WORDS + NEG_WORDS + ["unseenword"]
    with open(path, "w") as f:
        for i in range(n):
            spans = 1 + rng.randint(2)
            parts = []
            for _ in range(spans):
                parts.append(" ".join(rng.choice(words, rng.randint(1, 5))))
                parts.append("[ENT] %s [ENT]" % " ".join(
                    rng.choice(words, rng.randint(1, 3))))
            parts.append(" ".join(rng.choice(words, rng.randint(0, 4))))
            rels = [int(x) for x in rng.randint(0, N_RELATIONS + 3, spans)]
            ents = [int(x) for x in rng.randint(0, N_ENTITIES + 3, spans)]
            rec = {"text": " ".join(parts),
                   "relation_id": rels if spans > 1 else rels[0],
                   "replced_entity_id": ents if spans > 1 else ents[0]}
            f.write("%d\t%r\n" % (i, rec))


def _entity_names(rng, n):
    names = set()
    while len(names) < n:
        names.add("".join(rng.choice(CJK[:24], rng.randint(2, 4))))
    return sorted(names)


def write_kangaroo_tables(base, seed=0):
    """The entity CSV (index, main_name, '|'-joined aliases), the
    contrastive samples npy (level_1..level_3, some entities without
    level_3, which falls back to level_2) and the Poincaré concept table
    npy (utils/poincare.py over a small tree). Returns (paths, names)."""
    from easynlp_tpu_torch.utils.poincare import train_concept_embeddings
    rng = np.random.RandomState(seed)
    names = _entity_names(rng, 2 * N_ENTITIES)
    entity_file = os.path.join(base, "entities.csv")
    with open(entity_file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "main_name", "name_list"])
        for i in range(N_ENTITIES):
            w.writerow([i, names[2 * i], names[2 * i + 1]])
    samples = {}
    for i in range(N_ENTITIES - 1):  # the last entity has no samples
        levels = 3 if i % 3 else 2
        samples[i] = {}
        for level in range(1, levels + 1):
            text = "".join(rng.choice(CJK, rng.randint(3, 12)))
            samples[i]["level_%d" % level] = [{
                "tokens": text,
                "position_id": list(range(len(text)))}]
    samples_file = os.path.join(base, "samples.npy")
    np.save(samples_file, samples, allow_pickle=True)
    concept_file = os.path.join(base, "concepts.npy")
    edges = [(i, i // 3) for i in range(1, N_ENTITIES)]
    train_concept_embeddings(edges, N_ENTITIES,
                             dim=KANGAROO_UDP["concept_size"],
                             out_file=concept_file, epochs=3, batch_size=8)
    return (entity_file, samples_file, concept_file), names


def write_kangaroo_rows(path, n, names, seed):
    """id<TAB>CJK text that names 0-3 entities, sometimes close together
    (the entity_gap exclusion)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            parts = []
            for _ in range(rng.randint(0, 4)):
                parts.append("".join(rng.choice(CJK[24:], rng.randint(0, 5))))
                parts.append(names[rng.randint(len(names))])
            parts.append("".join(rng.choice(CJK[24:], rng.randint(1, 6))))
            f.write("%d\t%s\n" % (i, "".join(parts)))


def kangaroo_udp(paths):
    return " ".join(["enable_kangaroo=true", "entity_file=%s" % paths[0],
                     "samples_file=%s" % paths[1],
                     "concept_emb_file=%s" % paths[2]]
                    + ["%s=%s" % kv for kv in KANGAROO_UDP.items()])


def dkplm_udp(paths):
    return "enable_dkplm=true entity_emb_file=%s rel_emb_file=%s" % paths


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_knowledge_data"))
    make_knowledge_dir(os.path.join(base, "model"))
    write_dkplm_rows(os.path.join(base, "dkplm.tsv"), 24, seed=1)
    dk = write_dkplm_tables(base)
    kg, names = write_kangaroo_tables(base)
    write_kangaroo_rows(os.path.join(base, "kangaroo.tsv"), 24, names,
                        seed=2)
    return base, dk, kg


def _tokenizers(base):
    from easynlp_tpu.modelzoo.models.bert import (
        BertTokenizer as JaxTokenizer)

    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(base, "model")
    return (JaxTokenizer.from_pretrained(model),
            BertTokenizer.from_pretrained(model))


def _udp_dict(text):
    return dict(kv.split("=", 1) for kv in text.split())


def _assert_same_epochs(jax_ds, port_ds):
    assert len(jax_ds) == len(port_ds) > 0
    for epoch in (0, 1):
        jax_ds.set_epoch(epoch)
        port_ds.set_epoch(epoch)
        for i in range(len(jax_ds)):
            want, got = jax_ds[i], port_ds[i]
            assert set(got) == set(want)
            for k, w in want.items():
                assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the masks are drawn anew each epoch
    jax_ds.set_epoch(0)
    first = [jax_ds[i]["input_ids"] for i in range(len(jax_ds))]
    jax_ds.set_epoch(1)
    assert any((jax_ds[i]["input_ids"] != first[i]).any()
               for i in range(len(jax_ds)))


def test_dkplm_dataset_matches_jax(data_dir):
    """Every row's arrays (ids with MLM away from the spans, the TransE
    embeddings over the spans, their mask and decode labels) equal, bit
    for bit, at epochs 0 and 1; also through the per-thread RandomState
    after other threads drew."""
    from easynlp_tpu.appzoo.language_modeling.dkplm_data import (
        DKPLMPretrainDataset as JaxDataset)

    from easynlp_tpu_torch.appzoo.language_modeling.dkplm_data import (
        DKPLMPretrainDataset)
    base, dk, _ = data_dir
    jt, pt = _tokenizers(base)
    kw = dict(data_file=os.path.join(base, "dkplm.tsv"), max_seq_length=24,
              input_schema="id:str:1,text:str:1", first_sequence="text",
              user_defined_parameters=_udp_dict(dkplm_udp(tuple(dk))))
    jax_ds = JaxDataset(tokenizer=jt, **kw)
    port_ds = DKPLMPretrainDataset(tokenizer=pt, **kw)
    assert port_ds.knowledge_emb_size == KG_DIM
    _assert_same_epochs(jax_ds, port_ds)
    assert sum(int(port_ds[i]["insert_know_position_mask"].sum())
               for i in range(len(port_ds))) > 20
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        threaded = list(pool.map(lambda i: port_ds[i],
                                 range(len(port_ds))))
    for i, row in enumerate(threaded):
        np.testing.assert_array_equal(row["input_ids"],
                                      jax_ds[i]["input_ids"])


def test_kangaroo_dataset_matches_jax(data_dir):
    """The trie, the sample and concept tables, and every row's arrays
    (linked entity positions, entity-aware masks, the gathered samples and
    concepts) equal, bit for bit, at epochs 0 and 1."""
    from easynlp_tpu.appzoo.language_modeling.kangaroo_data import (
        KangarooPretrainDataset as JaxDataset)

    from easynlp_tpu_torch.appzoo.language_modeling.kangaroo_data import (
        KangarooPretrainDataset)
    base, _, kg = data_dir
    jt, pt = _tokenizers(base)
    kw = dict(data_file=os.path.join(base, "kangaroo.tsv"),
              max_seq_length=24, input_schema="id:str:1,text:str:1",
              first_sequence="text",
              user_defined_parameters=_udp_dict(kangaroo_udp(kg)))
    jax_ds = JaxDataset(tokenizer=jt, **kw)
    port_ds = KangarooPretrainDataset(tokenizer=pt, **kw)
    assert port_ds.tokenid2entityid == jax_ds.tokenid2entityid
    for table in ("tokenidVec", "positionidVec", "conceptEmbVec"):
        np.testing.assert_array_equal(getattr(port_ds, table),
                                      getattr(jax_ds, table), err_msg=table)
    _assert_same_epochs(jax_ds, port_ds)
    rows = [port_ds[i] for i in range(len(port_ds))]
    assert any(r["ent_mask"].sum() == 0 for r in rows)
    assert any(r["entities_position"].max() == 2 for r in rows)


def test_token_trie_matches_jax():
    from easynlp_tpu.data.entity_trie import TokenTrie as JaxTrie

    from easynlp_tpu_torch.data.entity_trie import TokenTrie
    rng = np.random.RandomState(3)
    words = [list(rng.randint(0, 6, rng.randint(1, 5))) for _ in range(20)]
    tries = (JaxTrie(), TokenTrie())
    for t in tries:
        for w in words:
            t.add_word(w)
    sentence = list(rng.randint(0, 6, 60))
    hits = 0
    for start in range(len(sentence)):
        want = tries[0].search(sentence, start)
        assert tries[1].search(sentence, start) == want
        hits += len(want) > 1
    assert hits > 0  # some starts end several stored words


def test_poincare_embedding_matches_jax():
    """From one seed the port's numpy copy gives the JAX package's
    embedding bit for bit, inside the unit ball."""
    from easynlp_tpu.utils.poincare import (
        PoincareEmbedding as JaxEmbedding)

    from easynlp_tpu_torch.utils.poincare import (
        PoincareEmbedding, poincare_distance)
    edges = [(i, i // 2) for i in range(1, 30)]
    want = JaxEmbedding(30, dim=6, seed=4).train(edges, epochs=4,
                                                 batch_size=8, burn_in=2)
    got = PoincareEmbedding(30, dim=6, seed=4).train(edges, epochs=4,
                                                     batch_size=8, burn_in=2)
    np.testing.assert_array_equal(got, want)
    assert np.linalg.norm(got, axis=-1).max() < 1.0
    assert np.isfinite(poincare_distance(got[1:], got[:1])).all()
