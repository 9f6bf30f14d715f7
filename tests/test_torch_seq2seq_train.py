"""BART seq2seq fine-tuning end to end: `--mode=train|evaluate
--app_name=sequence_generation` through the JAX package's CLI and the
PyTorch port's CLI on one tiny BART directory (2 + 2 layers, d_model 32, a
byte-level BPE vocab.json/merges.txt, HF-named weights made with numpy from a
seed and saved as pytorch_model.bin). Both run in f32 with dropout 0 on the
CPU.

Bounds: the datasets' features are identical; after 4 AdamW steps the
port's saved parameters are within 1e-5 of the JAX trainer's (the bound
tests/test_torch_train.py holds BERT's trajectory to) and the per-step
losses and gradient norms within rtol 1e-5. AdamW runs with epsilon 1e-3:
the key projections' biases get no true gradient (softmax ignores a
constant per row), only rounding noise of ~1e-7, which AdamW's default
epsilon of 1e-8 would scale up to a step of about the learning rate in a
direction set by that noise, a different one in each framework. The real
gradients here are ~1e-2 and larger, so their steps stay within a few
percent of plain Adam's. One configuration has
--sequence_length=520, so the encoder's self-attention and the decoder's
cross-attention take the port's flash path (its plain twins here) with a
gradient; the other is short (the short path). Evaluation generates greedily
at f32, where the two models' logits agree far inside the gaps between the
top tokens, so BLEU and ROUGE-L must be equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_bart import TINY, hf_state_dict
from test_torch_sequence_generation import MERGES, write_tokenizer

from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (
    bytes_to_unicode,
)

SCHEMA = "src:str:1,tgt:str:1"
WORDS = ["the", "model", "then", "in", "an", "other", "on", "here", "there",
         "generation", "token", "cache", "decode", "rather", "one"]


def make_bart_dir(model_dir, seed=0):
    os.makedirs(model_dir, exist_ok=True)
    from easynlp_tpu_torch.modelzoo.models.bart import BartConfig
    config = dict(TINY, model_type="bart")
    config["vocab_size"] = write_tokenizer(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    state = hf_state_dict(BartConfig(**config), seed)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               os.path.join(model_dir, "pytorch_model.bin"))
    return config


def make_tsv(path, n, seed, min_words=2, max_words=12):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            src = " ".join(rng.choice(WORDS, rng.randint(min_words,
                                                         max_words + 1)))
            tgt = " ".join(rng.choice(WORDS, rng.randint(1, 6)))
            f.write("%s\t%s\n" % (src, tgt))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_seq2seq"))
    make_bart_dir(os.path.join(base, "model"))
    make_tsv(os.path.join(base, "train.tsv"), 32, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 10, seed=2)
    # sources of 100..300 words, most past 520 tokens
    make_tsv(os.path.join(base, "train_long.tsv"), 32, seed=3, min_words=100,
             max_words=300)
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


def _run_port(argv):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    return default_main_fn(initialize_easynlp(args_list=argv
                                              + ["--device=cpu"]))


def _run_jax(argv):
    from easynlp_tpu.appzoo.api import default_main_fn
    from easynlp_tpu.utils.initializer import initialize_easynlp
    _fresh_args()
    return default_main_fn(initialize_easynlp(args_list=argv))


def _common(seq_len):
    return ["--app_name=sequence_generation", "--input_schema=" + SCHEMA,
            "--first_sequence=src", "--second_sequence=tgt",
            "--sequence_length=%d" % seq_len, "--dtype=float32"]


def train_argv(base, table, ckpt, seq_len, *extra):
    return ["--mode=train", "--tables=%s/%s" % (base, table),
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=1e-3", "--adam_epsilon=1e-3",
            "--logging_steps=1",
            "--micro_batch_size=8", "--optimizer_type=AdamW",
            "--pretrained_model_name_or_path=%s/model" % base,
            *_common(seq_len), *extra]


TRAJECTORIES = {"short": ("train.tsv", 24), "flash-520": ("train_long.tsv",
                                                           520)}


@pytest.fixture(scope="module")
def trajectories(tiny):
    """Both CLIs on each configuration: (jax trainer, port trainer, port
    checkpoint dir)."""
    out = {}
    for name, (table, seq_len) in TRAJECTORIES.items():
        j = _run_jax(train_argv(tiny, table, os.path.join(tiny, "jax_" + name),
                                seq_len))
        ckpt = os.path.join(tiny, "port_" + name)
        out[name] = (j, _run_port(train_argv(tiny, table, ckpt, seq_len)),
                     ckpt)
    return out


def test_dataset_features_match_jax(tiny):
    """The same TSV through both packages' SequenceGenerationDataset (the
    JAX defaults: max_target_length 64, decoder_start_token_id 0, -100 on
    the label padding) gives identical features."""
    from easynlp_tpu.appzoo.sequence_generation.data import (
        SequenceGenerationDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.gpt2 import GPT2Tokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.sequence_generation.data import (
        SequenceGenerationDataset)
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    model = os.path.join(tiny, "model")
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="src",
              second_sequence="tgt")
    want = JaxDataset(os.path.join(tiny, "train.tsv"),
                      JaxTok.from_pretrained(model), **kw).features
    got = SequenceGenerationDataset(os.path.join(tiny, "train.tsv"),
                                    GPT2Tokenizer.from_pretrained(model),
                                    **kw).features
    assert sorted(got) == sorted(want) == [
        "attention_mask", "decoder_attention_mask", "decoder_input_ids",
        "input_ids", "labels"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["labels"].shape == (32, 64)
    assert (got["labels"] == -100).any() and (got["attention_mask"] == 0).any()


def write_bart_vocab(model_dir, merges=MERGES):
    """vocab.json with BART's specials at 0-3 (<s> <pad> </s> <unk>), then
    the 256 byte symbols, one token per merge, and <mask> last; no
    <|endoftext|>. Returns the vocab size."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for s in bytes_to_unicode().values():
        vocab[s] = len(vocab)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<mask>"] = len(vocab)
    with open(os.path.join(model_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(model_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join("%s %s\n" % m for m in merges))
    return len(vocab)


def test_vocab_without_endoftext_is_refused(tiny, tmp_path):
    """A real BART vocabulary has <s>/<pad>/</s>/<unk>/<mask> and no
    <|endoftext|>, the GPT-2 tokenizer's EOS and pad token, which BART
    checkpoints get from the JAX package's tokenizer routing: its eos/pad
    ids are then None and the JAX dataset refuses it, failing while padding
    the sources (ROADMAP C11). The port routes it to its BartTokenizer and
    loads it with BART's ids: sources <s> ... </s> padded with <pad> (1),
    targets ending in </s> (2), decoder inputs starting from id 0 (the
    start-token mismatch both packages keep); the GPT-2 tokenizer on it
    still raises a ValueError that names the token."""
    from easynlp_tpu.appzoo.sequence_generation.data import (
        SequenceGenerationDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.gpt2 import GPT2Tokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.sequence_generation.data import (
        SequenceGenerationDataset)
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.modelzoo.models.bart import BartTokenizer
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    write_bart_vocab(str(tmp_path))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(TINY, model_type="bart"), f)
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="src",
              second_sequence="tgt")
    jax_tok = JaxTok.from_pretrained(str(tmp_path))
    assert jax_tok.eos_token_id is None and jax_tok.pad_token_id is None
    with pytest.raises(TypeError):
        JaxDataset(os.path.join(tiny, "train.tsv"), jax_tok, **kw)
    with pytest.raises(ValueError, match="<|endoftext|>"):
        SequenceGenerationDataset(os.path.join(tiny, "train.tsv"),
                                  GPT2Tokenizer.from_pretrained(str(tmp_path)),
                                  **kw)
    tok = tokenizer_for(str(tmp_path))
    assert isinstance(tok, BartTokenizer)
    assert (tok.bos_token_id, tok.pad_token_id, tok.eos_token_id,
            tok.unk_token_id) == (0, 1, 2, 3)
    f = SequenceGenerationDataset(os.path.join(tiny, "train.tsv"), tok,
                                  **kw).features
    real = f["attention_mask"].sum(1)
    assert (f["input_ids"][:, 0] == 0).all()
    assert all(row[n - 1] == 2 and (row[n:] == 1).all()
               for row, n in zip(f["input_ids"], real))
    n_tgt = f["decoder_attention_mask"].sum(1)
    assert (f["decoder_input_ids"][:, 0] == 0).all()
    assert all(row[n - 1] == 2 for row, n in zip(f["labels"], n_tgt))


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_training_trajectory_matches_jax(trajectories, name):
    """Four AdamW steps through each CLI: the same losses and grad norms
    step by step, the same final parameters (the port's saved
    pytorch_model.bin against the JAX trainer's params)."""
    from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
        state_dict_from_jax)
    from easynlp_tpu_torch.ops import attention as A
    jax_trainer, port, ckpt = trajectories[name]
    assert port.global_step == jax_trainer.global_step == 4
    assert port.nonfinite_skips == 0
    want = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_trainer.app.params),
        port.app.config)
    got = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                     weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    init = BartStateAtInit.get(os.path.join(os.path.dirname(ckpt), "model"))
    moved = max(float((got[k] - init[k]).abs().max()) for k in got)
    assert moved > 1e-4  # the comparison is not vacuous
    events = {}
    for tag, path in (("jax", jax_trainer.args.checkpoint_dir),
                      ("port", ckpt)):
        with open(os.path.join(path, "events.jsonl")) as f:
            events[tag] = [json.loads(line) for line in f
                           if json.loads(line)["kind"] == "train"]
    assert len(events["jax"]) == len(events["port"]) == 4
    for ej, ep in zip(events["jax"], events["port"]):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ep[key], ej[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    if name == "flash-520":  # sources fill all 520 positions
        real = port.train_loader.dataset.features["attention_mask"].sum(1)
        assert real.max() == 520 > A.SHORT_MAX_KV_LEN


class BartStateAtInit:
    """The model directory's weights as the port loads them."""

    @staticmethod
    def get(model_dir):
        from easynlp_tpu_torch.modelzoo.models.bart import BartConfig
        from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
            normalize_keys)
        config = BartConfig.from_pretrained(model_dir)
        return normalize_keys(torch.load(
            os.path.join(model_dir, "pytorch_model.bin"), weights_only=True),
            config)


def test_evaluate_matches_jax(trajectories, tiny):
    """--mode=evaluate of both CLIs on the port's trained checkpoint:
    greedy generation (64 tokens at most, as the JAX evaluator's default)
    scored by BLEU-4 and ROUGE-L against the dev targets, equal to JAX's."""
    _, _, ckpt = trajectories["short"]
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % tiny,
            "--checkpoint_dir=" + ckpt, "--micro_batch_size=8",
            *_common(24)]
    want = _run_jax(argv)
    got = _run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want] == ["bleu", "rouge_l"]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-9)
    assert any(w > 0 for _, w in want)  # not a vacuous comparison


def test_metrics_match_jax():
    """bleu4 and rouge_l on the same id lists, edge cases included."""
    from easynlp_tpu.appzoo.sequence_generation import evaluator as J
    from easynlp_tpu_torch.appzoo.sequence_generation import evaluator as P
    rng = np.random.RandomState(5)
    cases = [([], [1, 2]), ([1, 2], []), ([3, 3, 3], [3]), ([1, 2, 3], [4])]
    cases += [(list(rng.randint(0, 6, rng.randint(1, 20))),
               list(rng.randint(0, 6, rng.randint(1, 20)))) for _ in range(20)]
    for h, r in cases:
        assert P.bleu4(h, r) == pytest.approx(J.bleu4(h, r), abs=1e-12)
        assert P.rouge_l(h, r) == pytest.approx(J.rouge_l(h, r), abs=1e-12)


def test_gpt2_training_is_refused(tmp_path):
    """The JAX package does not train GPT-2 through this app: its trainer
    passes decoder_input_ids, which its GPT2LMHeadModel does not take. The
    port refuses the same command up front."""
    from test_torch_sequence_generation import make_model_dir
    make_model_dir(str(tmp_path / "gpt2"))
    make_tsv(str(tmp_path / "train.tsv"), 8, seed=4)
    argv = ["--mode=train", "--tables=%s/train.tsv" % tmp_path,
            "--checkpoint_dir=%s/ckpt" % tmp_path, "--epoch_num=1",
            "--micro_batch_size=8",
            "--pretrained_model_name_or_path=%s/gpt2" % tmp_path,
            *_common(12)]
    with pytest.raises(TypeError, match="decoder_input_ids"):
        _run_jax(argv)
    with pytest.raises(NotImplementedError, match="does not train GPT-2"):
        _run_port(argv)
