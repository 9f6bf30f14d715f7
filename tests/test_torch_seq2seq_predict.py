"""BART generation end to end: `--mode=predict --app_name=sequence_generation`
on a BART checkpoint through the JAX package's CLI and the PyTorch port's
CLI, and BART's tokenizer routing.

One tiny BART directory (test_torch_seq2seq_train.make_bart_dir: 2 + 2
layers, d_model 32, 4 heads, a byte-level BPE vocabulary with
<|endoftext|>, HF-named weights from a numpy seed) and one 10-row TSV. Both
CLIs run in f32 on the CPU, where the two models' logits agree far inside
the gaps between the top tokens (test_torch_bart.py), so `generated_ids`
must be identical, greedy and with two beams. The port's text columns hold
the tokens after the start column up to and including the first EOS
(ROADMAP C9); JAX's decode the whole buffer.

A second directory's vocabulary has BART's own specials (<s>, <pad>, </s>,
<unk>, <mask>) and no <|endoftext|>: the port routes it to its
BartTokenizer, which must give transformers' BartTokenizer's ids and text,
and its datasets and predictor run on it; the JAX package refuses it
(ROADMAP C11).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_bart import TINY, hf_state_dict
from test_torch_sequence_generation import read_rows
from test_torch_seq2seq_train import WORDS, make_bart_dir, write_bart_vocab

SCHEMA = "id:str:1,src:str:1"
OUT_SCHEMA = "predictions,beams,generated_ids"
N_ROWS = 10


def make_rows(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write("%d\t%s\n" % (i, " ".join(rng.choice(
                WORDS, rng.randint(2, 12)))))


def make_bart_special_dir(model_dir, seed=0):
    """A tiny BART whose vocabulary has BART's specials (TINY widths)."""
    from easynlp_tpu_torch.modelzoo.models.bart import BartConfig
    os.makedirs(model_dir, exist_ok=True)
    config = dict(TINY, model_type="bart",
                  vocab_size=write_bart_vocab(model_dir))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    state = hf_state_dict(BartConfig(**config), seed)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               os.path.join(model_dir, "pytorch_model.bin"))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_seq2seq_predict"))
    make_bart_dir(os.path.join(base, "model"))
    make_bart_special_dir(os.path.join(base, "bart_vocab"))
    make_rows(os.path.join(base, "rows.tsv"), N_ROWS, seed=7)
    return base


def _fresh_args():
    from easynlp_tpu.utils import global_vars
    global_vars._GLOBAL_ARGS = None


@pytest.fixture(autouse=True)
def _restore_global_args():
    from easynlp_tpu.utils import global_vars
    saved = global_vars._GLOBAL_ARGS
    yield
    global_vars._GLOBAL_ARGS = saved


def predict_argv(base, model, outputs, udp):
    return ["--mode=predict", "--app_name=sequence_generation",
            "--tables=%s/rows.tsv" % base, "--outputs=" + outputs,
            "--input_schema=" + SCHEMA, "--first_sequence=src",
            "--output_schema=" + OUT_SCHEMA, "--append_cols=id",
            "--checkpoint_dir=%s/%s" % (base, model), "--micro_batch_size=4",
            "--sequence_length=16", "--dtype=float32",
            "--user_defined_parameters=" + udp]


def real_tokens(ids, eos):
    """The tokens after the start column, up to and including the first
    EOS (ROADMAP C9)."""
    generated = list(ids[1:])
    return generated[:generated.index(eos) + 1] if eos in generated \
        else generated


@pytest.mark.parametrize("udp", [
    "max_decoder_length=8",
    "max_decoder_length=7 num_beams=2 num_return_sequences=2",
], ids=["greedy", "beams"])
def test_bart_predict_cli_matches_jax(fixture_dir, udp):
    """10 rows, micro batch 4 (the last batch padded), sources of 2-12 words
    (truncated at 16 tokens): identical generated_ids, each row the
    decoder's buffer with the start token first; `predictions` decodes
    that buffer's real tokens, and the first of the two beams is it."""
    from easynlp_tpu import cli as jax_cli
    from easynlp_tpu_torch import cli as torch_cli
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.ops import attention as A

    tag = "beams" if "num_beams" in udp else "greedy"
    jax_out = os.path.join(fixture_dir, "jax_%s.tsv" % tag)
    torch_out = os.path.join(fixture_dir, "torch_%s.tsv" % tag)
    _fresh_args()
    assert jax_cli.main(predict_argv(fixture_dir, "model", jax_out, udp)) == 0
    _fresh_args()
    A.short_attention_fwd.launches = 0
    assert torch_cli.main(predict_argv(fixture_dir, "model", torch_out, udp)
                          + ["--device=cpu"]) == 0
    assert A.short_attention_fwd.launches == 0  # CPU: the plain twin

    jax_rows, torch_rows = read_rows(jax_out), read_rows(torch_out)
    assert len(jax_rows) == len(torch_rows) == N_ROWS
    assert [r[3] for r in torch_rows] == [str(i) for i in range(N_ROWS)]
    tok = tokenizer_for(os.path.join(fixture_dir, "model"))
    eos = start = 2  # BART's config: decoder start and EOS are one token
    length = int(udp.split()[0].split("=")[1])
    n_generated = 0
    for j, t in zip(jax_rows, torch_rows):
        assert t[2] == j[2]  # generated_ids, token for token
        ids = [int(x) for x in j[2].split()]
        assert len(ids) == length and ids[0] == start
        real = real_tokens(ids, eos)
        assert t[0] == tok.decode(real, skip_special_tokens=True)
        assert t[0]  # never empty: the cut starts after the start column
        n_generated += len(real)
        if "num_beams" in udp:
            assert len(t[1].split("||")) == 2 == len(j[1].split("||"))
            assert t[1].split("||")[0] == t[0]
    assert n_generated > N_ROWS  # rows hold more than their EOS


def test_bart_special_vocab_predicts_real_text(fixture_dir):
    """With BART's own specials, EOS (</s>, 2) is also the start token: the
    port's predictions decode the tokens after the start column up to the
    first </s>, which skip_special_tokens drops, so a row is empty only if
    its first generated token is </s>."""
    from easynlp_tpu_torch import cli as torch_cli
    from easynlp_tpu_torch.modelzoo.models.bart import BartTokenizer
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    out = os.path.join(fixture_dir, "torch_bart_vocab.tsv")
    _fresh_args()
    assert torch_cli.main(predict_argv(fixture_dir, "bart_vocab", out,
                                       "max_decoder_length=8")
                          + ["--device=cpu"]) == 0
    tok = tokenizer_for(os.path.join(fixture_dir, "bart_vocab"))
    assert isinstance(tok, BartTokenizer) and tok.eos_token_id == 2
    rows = read_rows(out)
    assert len(rows) == N_ROWS
    texts = 0
    for r in rows:
        ids = [int(x) for x in r[2].split()]
        assert ids[0] == 2 and len(ids) == 8
        real = real_tokens(ids, 2)
        assert r[0] == tok.decode(real, skip_special_tokens=True)
        assert bool(r[0]) == (real[0] != 2)
        texts += bool(r[0])
    assert texts > 0


@pytest.mark.parametrize("texts", [
    ("The model then decode", None),
    ("in an other token cache!", None),
    ("  here there  ", None),
    ("é über 123 ok", None),
    ("the model", "then token rather"),
], ids=["words", "punct", "spaces", "unicode", "pair"])
def test_bart_tokenizer_matches_transformers(fixture_dir, texts):
    """ids, attention mask and decoded text of the port's BartTokenizer
    against transformers' BartTokenizer on the same files (<s> A </s> and
    <s> A </s></s> B </s>, truncated at 12, padded with <pad>)."""
    from transformers import BartTokenizer as HFBartTokenizer
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    model = os.path.join(fixture_dir, "bart_vocab")
    ours = tokenizer_for(model)
    theirs = HFBartTokenizer(os.path.join(model, "vocab.json"),
                             os.path.join(model, "merges.txt"))
    a, b = texts
    want = theirs(a, b, max_length=12, padding="max_length", truncation=True)
    got = ours(a, b, max_length=12)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"],
                                  want["attention_mask"])
    assert (got["token_type_ids"] == 0).all()
    assert ours.decode(got["input_ids"]) == theirs.decode(
        want["input_ids"], skip_special_tokens=True)
    assert ours.decode(got["input_ids"], skip_special_tokens=False) == \
        theirs.decode(want["input_ids"])
    for name in ("bos", "eos", "pad", "unk", "mask", "cls", "sep"):
        assert getattr(ours, name + "_token_id") == getattr(
            theirs, name + "_token_id"), name


def test_endoftext_vocab_routes_to_the_jax_tokenizer(fixture_dir):
    """A BART checkpoint whose vocabulary has <|endoftext|> (and no </s> at
    the config's EOS id) gets the GPT-2 tokenizer, as the JAX route gives
    every BART checkpoint: the same ids, specials and text as JAX's."""
    from easynlp_tpu.appzoo.api import _tokenizer_for as jax_tokenizer_for
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    model = os.path.join(fixture_dir, "model")
    ours, theirs = tokenizer_for(model), jax_tokenizer_for(model)
    assert type(ours) is GPT2Tokenizer
    assert type(theirs).__name__ == "GPT2Tokenizer"
    texts = ["The model then decode", "in an other token cache!", "x"]
    want, got = theirs(texts, max_length=10), ours(texts, max_length=10)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("eos", "pad", "bos", "unk"):
        assert getattr(ours, name + "_token_id") == getattr(
            theirs, name + "_token_id")
    for row in got["input_ids"]:
        assert ours.decode(row) == theirs.decode(row)
