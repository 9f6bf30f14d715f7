"""MLM pretraining (`language_modeling`, BERT and RoBERTa) and
`data_augmentation` in the PyTorch port against the JAX package, and the
Trainer's host-to-device prefetch and non-finite guard.

Tiny models (2 layers, width 32, 4 heads, dropout 0) run in f32 on the CPU:
- BertForMaskedLM's logits, loss and gradients from one JAX init carried
  over by `mlm_state_dict_from_jax`, within 1e-5 (f32 in two frameworks,
  summed in other orders; the values are O(1)); the same for RoBERTa built
  from the JAX package's RobertaConfig, and against transformers'
  RobertaForMaskedLM loaded from its own `roberta.*`/`lm_head.*` names;
- the masked dataset bit for bit at epochs 0 and 1, directly and through
  DataLoader.set_epoch; the RoBERTa tokenizer's ids exactly;
- the evaluator's accuracy exactly and perplexity within 1e-6 relative (the
  same f32 formula; the NLLs differ by f32 rounding only);
- four training steps through both CLIs: losses, grad norms and the final
  parameters within 1e-5, the same evaluation; data_augmentation's text
  exactly;
- prefetch: the same batches in order, errors raised, the thread stopped
  after a break, the same trajectory at depth 0 and 2; a NaN step leaves
  parameters, AdamW moments and step count bit for bit as they were.
"""

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_text_match import (  # noqa: E402
    ATOL,
    TINY,
    WORDS,
    assert_cli_imports_no_jax,
    check_parity,
    eval_args,
    make_bert_dir,
    read_tsv,
    run_jax,
    run_port,
    stub_forward,
)

from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (  # noqa: E402,E501
    bytes_to_unicode,
)

SCHEMA = "id:str:1,text:str:1"
# RoBERTa's specials where roberta-base has them (<mask> last), the byte
# symbols of lowercase text, then the merges' tokens
ROBERTA_MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"),
                  ("a", "n"), ("e", "r"), ("o", "n"), ("r", "e"),
                  ("Ġ", "s"), ("t", "h"), ("Ġ", "w"), ("Ġ", "a")]
ROBERTA_TINY = dict(TINY, model_type="roberta", pad_token_id=1,
                    bos_token_id=0, eos_token_id=2, type_vocab_size=1,
                    max_position_embeddings=40, layer_norm_eps=1e-5,
                    hidden_act="gelu", initializer_range=0.02)


def write_roberta_tokenizer(model_dir):
    """vocab.json and merges.txt of a byte-level BPE over lowercase text:
    <s> 0, <pad> 1, </s> 2, <unk> 3, the bytes of 'a'-'z', ' ' and '.'
    as GPT-2 maps them, one token per merge, <mask> last. Returns the
    vocab size."""
    table = bytes_to_unicode()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for b in sorted(set(b"abcdefghijklmnopqrstuvwxyz .")):
        vocab[table[b]] = len(vocab)
    for a, b in ROBERTA_MERGES:
        vocab.setdefault(a + b, len(vocab))
    vocab["<mask>"] = len(vocab)
    with open(os.path.join(model_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(model_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        f.write("".join("%s %s\n" % m for m in ROBERTA_MERGES))
    return len(vocab)


def _hf_roberta(config, seed):
    """transformers' RobertaForMaskedLM at `config`, every parameter moved
    off its init by seeded noise (so biases and LayerNorms count)."""
    from transformers import RobertaConfig as HFRobertaConfig
    from transformers import RobertaForMaskedLM
    hf_config = HFRobertaConfig(**{k: v for k, v in config.items()
                                   if k != "model_type"})
    torch.manual_seed(seed)
    model = RobertaForMaskedLM(hf_config).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def make_mlm_dir(model_dir, model_type="bert", seed=0):
    """A tiny masked-LM directory with HF names. bert: the fixtures'
    WordPiece vocab and `bert.*` weights (pooler included, which the MLM
    app drops) plus `cls.predictions.{transform.*, bias, decoder.weight}`;
    roberta: a byte-level BPE vocab and transformers' own
    RobertaForMaskedLM state dict (`roberta.*`, `lm_head.*`). Returns the
    config dict."""
    if model_type == "roberta":
        os.makedirs(model_dir, exist_ok=True)
        config = dict(ROBERTA_TINY,
                      vocab_size=write_roberta_tokenizer(model_dir))
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(config, f)
        state = _hf_roberta(config, seed).state_dict()
        torch.save({k: v.contiguous() for k, v in state.items()},
                   os.path.join(model_dir, "pytorch_model.bin"))
        return config
    config = make_bert_dir(model_dir, seed=seed)
    path = os.path.join(model_dir, "pytorch_model.bin")
    state = torch.load(path, weights_only=True)
    rng = np.random.RandomState(seed + 2)
    e, v = config["hidden_size"], config["vocab_size"]

    def noise(*shape, mean=0.0, std=0.2):
        return torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32))
    base = "cls.predictions."
    state[base + "transform.dense.weight"] = noise(e, e)
    state[base + "transform.dense.bias"] = noise(e, std=0.1)
    state[base + "transform.LayerNorm.weight"] = noise(e, mean=1.0, std=0.1)
    state[base + "transform.LayerNorm.bias"] = noise(e, std=0.1)
    state[base + "bias"] = noise(v, std=0.1)
    state[base + "decoder.weight"] = \
        state["bert.embeddings.word_embeddings.weight"]
    torch.save(state, path)
    return config


def make_rows(path, n, seed):
    """n rows "id<TAB>text" of 3-12 words; "unseenword" splits into
    WordPiece continuations, which whole-word masking groups."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.choice(WORDS, rng.randint(3, 13))
            f.write("%d\t%s\n" % (i, " ".join(words)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_language_modeling"))
    make_mlm_dir(os.path.join(base, "model"))
    make_mlm_dir(os.path.join(base, "roberta"), "roberta")
    make_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    make_rows(os.path.join(base, "dev.tsv"), 10, seed=2)
    return base


def _jax_config(config):
    from easynlp_tpu.modelzoo.models.bert import BertConfig, RobertaConfig
    cls = RobertaConfig if config.get("model_type") == "roberta" \
        else BertConfig
    return cls(**{k: v for k, v in config.items() if k != "model_type"})


def _port_config(config):
    from easynlp_tpu_torch.modelzoo.models.bert import (BertConfig,
                                                         RobertaConfig)
    cls = RobertaConfig if config.get("model_type") == "roberta" \
        else BertConfig
    return cls(**{k: v for k, v in config.items() if k != "model_type"})


def _jax_mlm(config, seed=0):
    """(JAX module, params): the JAX app's BertForMaskedLM at `config`'s
    widths, its own init moved by 0.05 N(0, 1) noise."""
    from easynlp_tpu.appzoo.language_modeling.model import LanguageModeling
    module = LanguageModeling.build_module(_jax_config(config),
                                           dtype=jnp.float32)
    params = LanguageModeling.init_params(module, module.config, seed)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
    return module, params


def _port_mlm(config, state_dict):
    from easynlp_tpu_torch.modelzoo.models.bert import BertForMaskedLM
    module = BertForMaskedLM(_port_config(config), dtype=torch.float32,
                             device="cpu")
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def _mlm_inputs(seed, vocab, pad, b=6, s=12):
    """Random ids (pad at the padded tail), a right-padded mask and labels
    at about 30% of the real positions."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.randint(4, vocab, (b, s)), pad).astype(
        np.int32)
    labels = np.where((rng.rand(b, s) < 0.3) & (mask == 1),
                      rng.randint(4, vocab, (b, s)), -100).astype(np.int32)
    return ({"input_ids": ids, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids)}, {"label_ids": labels})


def _bert_config(fixture_dir):
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        return json.load(f)


def _roberta_config(fixture_dir):
    with open(os.path.join(fixture_dir, "roberta", "config.json")) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_mlm_head_matches_jax(fixture_dir):
    """BertMLMHead alone (dense, gelu, LayerNorm, the tied decoder, the
    vocab bias) on random hidden states and embeddings."""
    from easynlp_tpu.modelzoo.models.bert.modeling_bert import (
        BertMLMHead as JaxHead)
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        BertMLMHead)
    config = _bert_config(fixture_dir)
    e, v = config["hidden_size"], config["vocab_size"]
    rng = np.random.RandomState(3)
    hidden = rng.standard_normal((3, 5, e)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((v, e))).astype(np.float32)
    head = JaxHead(_jax_config(config), dtype=jnp.float32)
    from flax import linen as nn
    params = nn.unbox(head.init(jax.random.PRNGKey(0), jnp.asarray(hidden),
                                jnp.asarray(emb))["params"])
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
    want = head.apply({"params": params}, jnp.asarray(hidden),
                      jnp.asarray(emb))
    port = BertMLMHead(_port_config(config))
    port.load_state_dict({
        "dense.weight": torch.from_numpy(params["transform"]["kernel"].T),
        "dense.bias": torch.from_numpy(params["transform"]["bias"]),
        "LayerNorm.weight": torch.from_numpy(params["transform_ln"]["scale"]),
        "LayerNorm.bias": torch.from_numpy(params["transform_ln"]["bias"]),
        "bias": torch.from_numpy(params["bias"])})
    got = port(torch.from_numpy(hidden), torch.from_numpy(emb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("model_type", ["bert", "roberta"])
def test_masked_lm_matches_jax(fixture_dir, model_type):
    """BertForMaskedLM's logits and last hidden state, the MLM loss and
    every gradient (the tied word embeddings take the decoder's share),
    against the JAX app's module built with BertConfig or, for RoBERTa,
    with the JAX package's RobertaConfig (positions from padding_idx + 1;
    pad 1 fills the padded tail)."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        LanguageModeling as JaxApp)
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        LanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        mlm_state_dict_from_jax)
    config = (_roberta_config if model_type == "roberta"
              else _bert_config)(fixture_dir)
    module, params = _jax_mlm(config)
    state = mlm_state_dict_from_jax(params, module.config)
    tmodule = _port_mlm(config, state)
    inputs, batch = _mlm_inputs(4, config["vocab_size"],
                                config.get("pad_token_id", 0))
    batch.update(inputs)
    want = check_parity(JaxApp, LanguageModeling, module, params, tmodule,
                        inputs, batch, mlm_state_dict_from_jax, module.config)
    assert set(want) == {"logits", "last_hidden_state"}


def test_roberta_matches_transformers(fixture_dir):
    """The port's RoBERTa MLM loads transformers' RobertaForMaskedLM state
    dict as it is (`roberta.*`, `lm_head.*`, the tied decoder and the
    position-id buffer skipped) and gives its logits within 1e-5; its own
    export loads back into transformers' model and gives them again."""
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        LanguageModeling)
    config = _roberta_config(fixture_dir)
    hf = _hf_roberta(config, seed=0)
    app = LanguageModeling.from_pretrained(
        os.path.join(fixture_dir, "roberta"), device="cpu")
    assert app.config.model_type == "roberta"
    inputs, _ = _mlm_inputs(5, config["vocab_size"], 1)
    t = {k: torch.from_numpy(v).long() for k, v in inputs.items()}
    with torch.no_grad():
        want = hf(input_ids=t["input_ids"],
                  attention_mask=t["attention_mask"]).logits
        got = app.forward(t)["logits"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
        exported = app.export_state_dict()
        assert {k.split(".")[0] for k in exported} == {"roberta", "lm_head"}
        again = _hf_roberta(config, seed=9)
        missing, unexpected = again.load_state_dict(exported, strict=False)
        assert not unexpected
        assert all(k.startswith("lm_head.decoder.") for k in missing), missing
        again.tie_weights()
        np.testing.assert_allclose(
            again(input_ids=t["input_ids"],
                  attention_mask=t["attention_mask"]).logits.numpy(),
            want.numpy(), atol=ATOL, rtol=0)


def test_roberta_reference_fault_c16(fixture_dir):
    """ROADMAP C16, pinned. The JAX app reads a RoBERTa checkpoint as BERT:
    its load_config is BertConfig.from_pretrained, which leaves out
    RobertaConfig's position ids (a class attribute, not in config.json),
    so it numbers positions from 0; and its converter strips only a
    `bert.` prefix and looks for the head only under `cls.predictions.`,
    so transformers' RoBERTa names do not load. The port routes the
    checkpoint through RobertaConfig and those names."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        LanguageModeling as JaxApp)
    from easynlp_tpu.modelzoo.models.bert.conversion import (
        convert_bert_for_masked_lm)
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        LanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        mlm_state_dict_from_jax)
    model_dir = os.path.join(fixture_dir, "roberta")
    jax_config = JaxApp.load_config(model_dir)
    assert not getattr(jax_config, "position_ids_from_padding_idx", False)
    port_config = LanguageModeling.load_config(model_dir)
    assert port_config.position_ids_from_padding_idx
    assert port_config.pad_token_id == 1 and port_config.type_vocab_size == 1
    hf_state = {k: v.numpy() for k, v in torch.load(
        os.path.join(model_dir, "pytorch_model.bin"),
        weights_only=True).items()}
    with pytest.raises(KeyError, match="embeddings.word_embeddings"):
        convert_bert_for_masked_lm(hf_state, jax_config)
    # the same weights through both configs: positions from 0 move every
    # logit of the JAX app's reading
    config = _roberta_config(fixture_dir)
    module, params = _jax_mlm(config)
    as_bert = JaxApp.build_module(jax_config, dtype=jnp.float32)
    inputs, _ = _mlm_inputs(6, config["vocab_size"], 1)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jax_logits = np.asarray(as_bert.apply({"params": params}, **jin)["logits"])
    port = _port_mlm(config, mlm_state_dict_from_jax(params, module.config))
    with torch.no_grad():
        port_logits = port(**{k: torch.from_numpy(v) for k, v in
                              inputs.items()})["logits"].numpy()
    assert np.abs(port_logits - jax_logits).max() > 100 * ATOL
    want = np.asarray(module.apply({"params": params}, **jin)["logits"])
    np.testing.assert_allclose(port_logits, want, atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# tokenizer, dataset, evaluator
# --------------------------------------------------------------------------

TOKENIZER_TEXTS = ["the weather then", "in an other", "there  is.",
                   "unknown symbols 42 !", "", "the rather long sentence "
                   "that runs past the end of the window here"]


def test_roberta_tokenizer_matches_jax(fixture_dir):
    """RobertaTokenizer's ids, masks and token types against the JAX
    package's and transformers' on single texts and pairs, padded and
    truncated to 12; specials, vocab size and decode too."""
    from transformers import RobertaTokenizer as HFTokenizer

    from easynlp_tpu.modelzoo.models.bert.tokenization_roberta import (
        RobertaTokenizer as JaxTokenizer)
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    model_dir = os.path.join(fixture_dir, "roberta")
    port = tokenizer_for(model_dir)
    assert type(port).__name__ == "RobertaTokenizer"
    files = [os.path.join(model_dir, n) for n in ("vocab.json",
                                                  "merges.txt")]
    jax_tok = JaxTokenizer(*files)
    hf = HFTokenizer(*files)
    for attr in ("all_special_ids", "pad_token_id", "mask_token_id",
                 "cls_token_id", "sep_token_id", "vocab_size"):
        assert getattr(port, attr) == getattr(jax_tok, attr), attr
    assert (port.pad_token_id, port.mask_token_id) == (1, port.vocab_size - 1)
    pairs = TOKENIZER_TEXTS[::-1]
    for text_pair in (None, pairs):
        got = port(TOKENIZER_TEXTS, text_pair, max_length=12)
        want = jax_tok(TOKENIZER_TEXTS, text_pair, max_length=12)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ref = hf(TOKENIZER_TEXTS, text_pair, max_length=12,
                 padding="max_length", truncation="longest_first")
        np.testing.assert_array_equal(got["input_ids"], ref["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"],
                                      ref["attention_mask"])
    for row in got["input_ids"]:
        assert port.decode(row) == jax_tok.decode(row)


@pytest.mark.parametrize("model_type", ["bert", "roberta"])
def test_dataset_matches_jax(fixture_dir, model_type):
    """LanguageModelingDataset's masked rows bit for bit against the JAX
    package's, at epochs 0 and 1, row by row and through each package's
    shuffling DataLoader after set_epoch (which the port's DataLoader now
    passes on to the dataset, as the JAX one does). Masks differ between
    epochs, and whole words are masked together."""
    from easynlp_tpu.appzoo.language_modeling.data import (
        LanguageModelingDataset as JaxDataset)
    from easynlp_tpu.appzoo.api import _tokenizer_for as jax_tokenizer_for
    from easynlp_tpu.data.dataset import DataLoader as JaxLoader
    from easynlp_tpu_torch.appzoo.language_modeling.data import (
        LanguageModelingDataset)
    from easynlp_tpu_torch.data.dataset import DataLoader
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    model_dir = os.path.join(fixture_dir,
                             "roberta" if model_type == "roberta" else "model")
    path = os.path.join(fixture_dir, "train.tsv")
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="text",
              mask_probability=0.3)
    want = JaxDataset(path, jax_tokenizer_for(model_dir), **kw)
    got = LanguageModelingDataset(path, tokenizer_for(model_dir), **kw)
    np.testing.assert_array_equal(got.groups, want.groups)
    if model_type == "bert":  # WordPiece continuations share a group
        assert (got.groups[:, 1:] == got.groups[:, :-1]).any()
    loaders = (DataLoader(got, 8, shuffle=True, seed=5),
               JaxLoader(want, 8, shuffle=True, seed=5))
    epochs = []
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        assert got.epoch == want.epoch == epoch
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for a, b in zip(*loaders):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        epochs.append(np.stack([got[i]["label_ids"] for i in range(len(got))]))
    assert (epochs[0] != -100).sum() > 20
    assert not np.array_equal(epochs[0], epochs[1])


def test_dataset_masks_do_not_depend_on_the_thread(fixture_dir):
    """Rows fetched by 8 DataLoader threads at once (each reseeding a
    RandomState of its own), with the interpreter switching threads every
    10 us, give the batches a serial fetch gives."""
    from easynlp_tpu_torch.appzoo.language_modeling.data import (
        LanguageModelingDataset)
    from easynlp_tpu_torch.data.dataset import DataLoader
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    tokenizer = tokenizer_for(os.path.join(fixture_dir, "model"))
    path = os.path.join(fixture_dir, "train.tsv")
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="text",
              mask_probability=0.3)
    serial = list(DataLoader(LanguageModelingDataset(path, tokenizer, **kw),
                             4, shuffle=True, seed=2))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threaded = list(DataLoader(LanguageModelingDataset(path, tokenizer,
                                                           **kw),
                                   4, shuffle=True, seed=2, num_workers=8))
    finally:
        sys.setswitchinterval(interval)
    assert len(threaded) == len(serial) == 8
    for a, b in zip(threaded, serial):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_evaluator_matches_jax(fixture_dir):
    """Masked-token accuracy and -perplexity on the same logits (fed to
    both evaluators' loops in place of a model) and the same dev rows: the
    accuracy exactly, the perplexity within 1e-6 relative."""
    from easynlp_tpu.appzoo.language_modeling.data import (
        LanguageModelingDataset as JaxDataset)
    from easynlp_tpu.appzoo.language_modeling.evaluator import (
        LanguageModelingEvaluator as JaxEvaluator)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.language_modeling.data import (
        LanguageModelingDataset)
    from easynlp_tpu_torch.appzoo.language_modeling.evaluator import (
        LanguageModelingEvaluator)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model_dir = os.path.join(fixture_dir, "model")
    path = os.path.join(fixture_dir, "dev.tsv")
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="text",
              mask_probability=0.3)
    jax_ds = JaxDataset(path, JaxTok.from_pretrained(model_dir), **kw)
    port_ds = LanguageModelingDataset(
        path, BertTokenizer.from_pretrained(model_dir), **kw)
    vocab = _bert_config(fixture_dir)["vocab_size"]
    rng = np.random.RandomState(7)
    # 10 rows in batches of 4: the padded third batch's repeats must not
    # count; logits scaled so that some argmaxes hit the label
    logits = (4 * rng.standard_normal((12, 16, vocab))).astype(np.float32)
    labels = np.stack([jax_ds[i]["label_ids"] for i in range(10)])
    hit = labels != -100
    logits[:10][hit, labels[hit]] += 6.0
    want_eval = JaxEvaluator(jax_ds, args=eval_args(4))
    got_eval = LanguageModelingEvaluator(port_ds, args=eval_args(4))
    stub_forward(want_eval, {"logits": logits}, to_torch=False)
    stub_forward(got_eval, {"logits": logits}, to_torch=True)
    want, got = want_eval.evaluate(None), got_eval.evaluate(None)
    assert [m for m, _ in got] == [m for m, _ in want] == ["accuracy",
                                                           "perplexity"]
    assert got[0][1] == want[0][1] and 0 < got[0][1] < 1
    assert got[1][1] < 0
    np.testing.assert_allclose(got[1][1], want[1][1], rtol=1e-6)


# --------------------------------------------------------------------------
# the CLIs: training, evaluation, data augmentation
# --------------------------------------------------------------------------

def common_argv():
    return ["--app_name=language_modeling", "--input_schema=" + SCHEMA,
            "--first_sequence=text", "--sequence_length=16",
            "--micro_batch_size=8", "--dtype=float32"]


def train_argv(fixture_dir, ckpt, model="model", *extra):
    return ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv"
            % (fixture_dir, fixture_dir),
            "--pretrained_model_name_or_path=%s/%s" % (fixture_dir, model),
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=1e-3", "--logging_steps=1",
            *common_argv(), *extra]


@pytest.fixture(scope="module")
def trajectories(fixture_dir):
    """Four AdamW steps on the tiny BERT through the JAX CLI and through
    the port's at prefetch depth 2 (the default) and 0: (JAX trainer,
    {depth: (port trainer, checkpoint dir)})."""
    jax_trainer = run_jax(train_argv(fixture_dir,
                                     os.path.join(fixture_dir, "ckpt_jax")))
    port = {}
    for depth in (2, 0):
        ckpt = os.path.join(fixture_dir, "ckpt_port_%d" % depth)
        port[depth] = (run_port(train_argv(
            fixture_dir, ckpt, "model",
            "--num_host_prefetch=%d" % depth)), ckpt)
    return jax_trainer, port


def test_mlm_trajectory_matches_jax(trajectories):
    """The same masked batches in the same order: per-step losses and grad
    norms within 1e-5 of the JAX Trainer's, and the final parameters (the
    port's pytorch_model.bin, HF names, against the JAX params) within
    1e-5; the same evaluation; prefetch off gives the same run bit for
    bit."""
    from easynlp_tpu.modelzoo.models.bert.conversion import (
        convert_bert_for_masked_lm)
    jax_trainer, port = trajectories
    trainer, ckpt = port[2]
    assert trainer.global_step == jax_trainer.global_step == 4
    assert trainer.nonfinite_skips == 0 and trainer.prefetch_depth == 2
    events = {}
    for tag, path in (("jax", jax_trainer.args.checkpoint_dir),
                      ("port", ckpt)):
        with open(os.path.join(path, "events.jsonl")) as f:
            events[tag] = [json.loads(line) for line in f]
    train_j = [e for e in events["jax"] if e["kind"] == "train"]
    train_p = [e for e in events["port"] if e["kind"] == "train"]
    assert len(train_j) == len(train_p) == 4
    for ej, ep in zip(train_j, train_p):
        for key in ("loss", "grad_norm", "lr", "nonfinite_skip"):
            np.testing.assert_allclose(ep[key], ej[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    eval_j = [e for e in events["jax"] if e["kind"] == "eval"][-1]
    eval_p = [e for e in events["port"] if e["kind"] == "eval"][-1]
    assert set(eval_p) == set(eval_j) >= {"accuracy", "perplexity"}
    for key in ("accuracy", "perplexity"):
        np.testing.assert_allclose(eval_p[key], eval_j[key], rtol=1e-5)
    got = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                     weights_only=True)
    want = jax.tree.map(np.asarray, jax_trainer.app.params)
    mine = convert_bert_for_masked_lm({k: v.numpy() for k, v in got.items()},
                                      jax_trainer.app.config)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    off, off_ckpt = port[0]
    assert off.prefetch_depth == 0
    assert [r["loss"] for r in off.step_records] == \
        [r["loss"] for r in trainer.step_records]
    again = torch.load(os.path.join(off_ckpt, "pytorch_model.bin"),
                       weights_only=True)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_cli_evaluate_matches_jax(fixture_dir, trajectories):
    """Both CLIs' --mode=evaluate on the port's checkpoint: the same
    accuracy and perplexity."""
    _, port = trajectories
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % fixture_dir,
            "--checkpoint_dir=" + port[2][1]] + common_argv()
    want, got = run_jax(argv), run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=1e-5)


def test_data_augmentation_matches_jax(fixture_dir, trajectories):
    """Both CLIs' --mode=predict --app_name=data_augmentation on the
    port's checkpoint: the same text, each row's augment_count (2) copies
    tab-joined after the appended id."""
    _, port = trajectories
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "aug_%s.tsv" % tag)
        run(["--mode=predict", "--app_name=data_augmentation",
             "--tables=%s/dev.tsv" % fixture_dir, "--outputs=" + outs[tag],
             "--checkpoint_dir=" + port[2][1], "--input_schema=" + SCHEMA,
             "--first_sequence=text", "--sequence_length=16",
             "--micro_batch_size=4", "--dtype=float32",
             "--output_schema=augmented", "--append_cols=id"])
    got, want = read_tsv(outs["port"]), read_tsv(outs["jax"])
    assert got == want
    assert len(got) == 10 and all(len(r) == 3 for r in got)
    assert [r[-1] for r in got] == [str(i) for i in range(10)]
    source = [r[1] for r in read_tsv(os.path.join(fixture_dir, "dev.tsv"))]
    assert any(r[0] != s or r[1] != s for r, s in zip(got, source))


def test_roberta_cli_trains_and_evaluates(fixture_dir):
    """The port's CLI trains the tiny RoBERTa (transformers' names as they
    are) for four steps and evaluates its checkpoint, which keeps the
    RoBERTa config, tokenizer files and names and loads into transformers'
    RobertaForMaskedLM with the same logits."""
    from transformers import RobertaForMaskedLM

    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        LanguageModeling)
    ckpt = os.path.join(fixture_dir, "ckpt_roberta")
    trainer = run_port(train_argv(fixture_dir, ckpt, "roberta"))
    assert trainer.global_step == 4 and trainer.nonfinite_skips == 0
    assert all(np.isfinite(r["loss"]) for r in trainer.step_records)
    with open(os.path.join(ckpt, "config.json")) as f:
        assert json.load(f)["model_type"] == "roberta"
    for name in ("vocab.json", "merges.txt"):
        assert os.path.exists(os.path.join(ckpt, name))
    results = run_port(["--mode=evaluate", "--tables=%s/dev.tsv"
                        % fixture_dir, "--checkpoint_dir=" + ckpt]
                       + common_argv())
    assert [m for m, _ in results] == ["accuracy", "perplexity"]
    assert np.isfinite([s for _, s in results]).all()
    hf = RobertaForMaskedLM.from_pretrained(ckpt).eval()
    app = LanguageModeling.from_pretrained(ckpt, device="cpu")
    inputs, _ = _mlm_inputs(8, app.config.vocab_size, 1)
    t = {k: torch.from_numpy(v).long() for k, v in inputs.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            app.forward(t)["logits"].numpy(),
            hf(input_ids=t["input_ids"],
               attention_mask=t["attention_mask"]).logits.numpy(),
            atol=ATOL, rtol=0)


def test_cli_imports_no_jax(fixture_dir, trajectories):
    """--mode=train and --mode=evaluate (language_modeling), and
    --mode=predict (data_augmentation), each in a fresh interpreter: no
    jax, flax or JAX-package module is loaded."""
    ckpt = os.path.join(fixture_dir, "ckpt_nojax")
    assert_cli_imports_no_jax(train_argv(fixture_dir, ckpt))
    assert_cli_imports_no_jax(["--mode=evaluate", "--tables=%s/dev.tsv"
                               % fixture_dir, "--checkpoint_dir=" + ckpt]
                              + common_argv())
    out = os.path.join(fixture_dir, "aug_nojax.tsv")
    assert_cli_imports_no_jax([
        "--mode=predict", "--app_name=data_augmentation",
        "--tables=%s/dev.tsv" % fixture_dir, "--outputs=" + out,
        "--checkpoint_dir=" + ckpt, "--input_schema=" + SCHEMA,
        "--first_sequence=text", "--sequence_length=16",
        "--output_schema=augmented", "--dtype=float32"])
    assert len(read_tsv(out)) == 10


@pytest.mark.parametrize("flag", ["enable_dkplm", "enable_kangaroo",
                                  "contrast_learning_flag", "enable_glm"])
def test_unported_variants_raise(fixture_dir, flag):
    """The A13 switches and enable_glm (A19), which raised here until they
    were ported, select their app, dataset and evaluator, as in the JAX
    package (test_torch_knowledge_cli.py trains the A13 variants,
    test_torch_glm.py the GLM one)."""
    from easynlp_tpu_torch.appzoo import api
    udp = {flag: "True"}
    want = {"enable_dkplm": ("DKPLMLanguageModeling",
                             "DKPLMPretrainDataset"),
            "enable_kangaroo": ("KangarooLanguageModeling",
                                "KangarooPretrainDataset"),
            "contrast_learning_flag": ("CKBertLanguageModeling",
                                       "LanguageModelingDataset"),
            "enable_glm": ("GLMSequenceGeneration",
                           "GLMPretrainDataset")}[flag]
    got = tuple(api._resolve(registry, "language_modeling", udp).__name__
                for registry in (api.MODEL_REGISTRY, api.DATASET_REGISTRY))
    assert got == want
    evaluator = ("GLMPretrainEvaluator" if flag == "enable_glm"
                 else "LanguageModelingEvaluator")
    assert api._resolve(api.EVALUATOR_REGISTRY, "language_modeling",
                        udp).__name__ == evaluator


# --------------------------------------------------------------------------
# prefetch and the non-finite guard
# --------------------------------------------------------------------------

def _batches(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError("bad row %d" % i)
        yield {"x": np.full((2, 3), i, np.int32), "_valid": np.ones(2)}


def _strip(batch):
    batch.pop("_valid")
    return batch


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_device_prefetch_keeps_order(depth):
    from easynlp_tpu_torch.data.prefetch import device_prefetch
    got = list(device_prefetch(_batches(7), "cpu", depth=depth,
                               transform=_strip))
    assert [sorted(b) for b in got] == [["x"]] * 7
    assert [int(b["x"][0, 0]) for b in got] == list(range(7))
    assert all(b["x"].dtype == torch.int32 for b in got)


@pytest.mark.parametrize("depth", [0, 2])
def test_device_prefetch_raises_producer_errors(depth):
    from easynlp_tpu_torch.data.prefetch import device_prefetch
    seen = []
    with pytest.raises(ValueError, match="bad row 3"):
        for b in device_prefetch(_batches(7, fail_at=3), "cpu", depth=depth):
            seen.append(int(b["x"][0, 0]))
    assert seen == [0, 1, 2]
    with pytest.raises(ValueError, match=">= 0"):
        next(device_prefetch(_batches(1), "cpu", depth=-1))


def test_device_prefetch_stops_after_break():
    """Leaving the loop early stops the producer (which would otherwise
    wait forever on the full queue) and drops what it staged."""
    from easynlp_tpu_torch.data.prefetch import device_prefetch
    fetched = []

    def endless():
        i = 0
        while True:
            fetched.append(i)
            yield {"x": np.full(2, i)}
            i += 1
    gen = device_prefetch(endless(), "cpu", depth=2)
    for b in gen:
        if int(b["x"][0]) == 3:
            break
    gen.close()
    assert not [t for t in threading.enumerate()
                if t.name == "device_prefetch"]
    # the 4 consumed, 2 queued, 1 in the producer's hand, and at most one
    # fetched while the queue drained
    assert len(fetched) <= 4 + 2 + 1 + 1


class _StandInStream:
    """Records, per thread, the events a stream is made to wait on."""

    def __init__(self):
        self.waits = []

    def wait_event(self, event):
        self.waits.append((event, threading.current_thread().name))


def test_device_prefetch_waits_on_every_dropped_batch(monkeypatch):
    """ROADMAP C17: a staged batch lives in the consumer stream's pool, so
    before it is dropped the consumer stream must wait on its copy's event.
    With a stand-in consumer stream and staging that hands out numbered
    events (the CUDA path on the CPU): depth 1, the consumer takes batch 0,
    waits until batch 1 is queued and batch 2 staged (the producer then
    blocks in put on the full queue), and stops. Batch 0 was waited on
    when handed out; batch 2's put fails and the producer waits on its
    event itself; the consumer's drain waits on batch 1's. Every staged
    batch was waited on exactly once."""
    from easynlp_tpu_torch.data import prefetch
    consumer = _StandInStream()
    staged = []

    def stage(batch, device, consumer_stream, side):
        assert consumer_stream is consumer
        staged.append(int(batch["x"][0]))
        return {"x": torch.from_numpy(batch["x"])}, ("event", staged[-1])
    monkeypatch.setattr(prefetch, "_streams", lambda d: (consumer, None))
    monkeypatch.setattr(prefetch, "_stage", stage)

    def endless():
        i = 0
        while True:
            yield {"x": np.full(2, i)}
            i += 1
    gen = prefetch.device_prefetch(endless(), "cuda", depth=1)
    assert int(next(gen)["x"][0]) == 0
    deadline = time.time() + 10
    while len(staged) < 3 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # the producer is in put, with batch 2 in its hand
    gen.close()
    assert staged == [0, 1, 2]
    assert sorted(consumer.waits) == [
        (("event", 0), "MainThread"), (("event", 1), "MainThread"),
        (("event", 2), "device_prefetch")]
    assert not [t for t in threading.enumerate()
                if t.name == "device_prefetch"]


@pytest.mark.parametrize("stop_after", [1, 3])
def test_device_prefetch_drain_waits_on_the_queued_batches(monkeypatch,
                                                           stop_after):
    """The same stand-ins at depth 3 over four batches, left after 1 or 3
    of them once the producer has queued the rest (the Trainer's
    break at t_total in mid-epoch): the events of the batches handed out
    and of those dropped are each waited on once."""
    from easynlp_tpu_torch.data import prefetch
    consumer = _StandInStream()
    staged = []

    def stage(batch, device, consumer_stream, side):
        staged.append(int(batch["x"][0]))
        return {"x": torch.from_numpy(batch["x"])}, ("event", staged[-1])
    monkeypatch.setattr(prefetch, "_streams", lambda d: (consumer, None))
    monkeypatch.setattr(prefetch, "_stage", stage)
    gen = prefetch.device_prefetch(({"x": np.full(2, i)} for i in range(4)),
                                   "cuda", depth=3)
    for _ in range(stop_after):
        next(gen)
    deadline = time.time() + 10
    while len(staged) < min(4, stop_after + 3) and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    gen.close()
    assert sorted(e for e, _ in consumer.waits) == [("event", i)
                                                    for i in staged]
    assert len(staged) == 4


def test_nonfinite_step_keeps_state_bit_identical(fixture_dir, monkeypatch):
    """A step whose loss is NaN, decided on the device: parameters, AdamW
    moments and the step count (which the schedule and the bias correction
    read) stay bit for bit as they were, the skip is counted, and the next
    step goes on from the count it left."""
    from test_torch_text_match import fresh_args

    from easynlp_tpu_torch.appzoo.language_modeling import model as M
    from easynlp_tpu_torch.appzoo.language_modeling.data import (
        LanguageModelingDataset)
    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    fresh_args()
    args = initialize_easynlp(args_list=train_argv(
        fixture_dir, os.path.join(fixture_dir, "ckpt_nan")) + [
            "--device=cpu"])
    model_dir = os.path.join(fixture_dir, "model")
    dataset = LanguageModelingDataset(
        os.path.join(fixture_dir, "train.tsv"), tokenizer_for(model_dir),
        max_seq_length=16, input_schema=SCHEMA, first_sequence="text")
    app = M.LanguageModeling.from_pretrained(model_dir, device="cpu")
    trainer = Trainer(app, dataset, args=args)
    batches = iter(trainer.train_loader)

    def step(poison):
        batch = next(batches)
        batch.pop("_valid")
        inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
        real = M.LanguageModeling.loss_fn
        if poison:
            monkeypatch.setattr(M.LanguageModeling, "loss_fn", staticmethod(
                lambda o, b: {"loss": real(o, b)["loss"] * float("nan")}))
        names, values = trainer._train_step(inputs)
        monkeypatch.setattr(M.LanguageModeling, "loss_fn",
                            staticmethod(real))
        return dict(zip(names, values.tolist()))

    def snapshot():
        opt = trainer.optimizer
        return ([p.detach().clone() for p in opt.params],
                {k: [t.clone() for t in v] for k, v in opt.state.items()},
                int(opt.count))
    assert step(False)["nonfinite_skip"] == 0
    params, state, count = snapshot()
    assert count == 1
    skipped = step(True)
    assert skipped["nonfinite_skip"] == 1 and np.isnan(skipped["loss"])
    params2, state2, count2 = snapshot()
    assert count2 == count
    for a, b in zip(params, params2):
        assert torch.equal(a, b)
    for key in state:
        for a, b in zip(state[key], state2[key]):
            assert torch.equal(a, b)
    assert step(False)["nonfinite_skip"] == 0
    assert int(trainer.optimizer.count) == 2
    assert not all(torch.equal(a, p) for a, p in
                   zip(params, trainer.optimizer.params))
