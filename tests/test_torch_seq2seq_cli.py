"""Slice 10 through the CLIs, on the CPU: T5, mT5, Pegasus and Randeng
under `--app_name=sequence_generation` and the dialogue `transformer`
under `--app_name=open_domain_dialogue`, each `--mode=train` (4 AdamW
steps), `--mode=evaluate` and `--mode=predict` in one fresh interpreter of
the port's (the five at once), which must load no jax, flax or
easynlp_tpu module; GPT-2 `--mode=evaluate`; ROADMAP reference fault 23.

Every model directory but mT5's holds the JAX package's own
flax_params.msgpack (written by its save_params from the JAX conversion of
the port's seeded init), so the port reads JAX checkpoints on every
family; mT5's holds pytorch_model.bin (the JAX model cannot build mT5's
untied head: reference fault 25). T5 also runs through the JAX CLI: per
step losses, gradient norms and learning rates within rtol 1e-5, and the
port's BLEU-4 and ROUGE-L of either checkpoint the same. f32 throughout,
dropout 0.
"""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pegasus import DIALOGUE_TINY, family_state_dict
from test_torch_sentencepiece import _cjk_vocab, write_transformer_tokenizer
from test_torch_t5 import T5_TINY, port_model
from test_torch_text_match import REPO, _restore_global_args  # noqa: F401
from test_torch_text_match import run_jax, run_port

SCHEMA = "id:str:1,src:str:1,tgt:str:1"
LETTERS = "etaoinshrdlucmfwypvbgkqjxz"
BART_TINY = dict(d_model=32, encoder_layers=2, decoder_layers=2,
                 encoder_attention_heads=4, decoder_attention_heads=4,
                 encoder_ffn_dim=64, decoder_ffn_dim=64,
                 max_position_embeddings=64, dropout=0.0,
                 attention_dropout=0.0, activation_dropout=0.0)
FAMILIES = ("t5", "mt5", "pegasus", "randeng", "dialogue")


def _sp_model(path, n):
    sys.path.insert(0, REPO)
    import chip_smoke
    pieces = chip_smoke.t5_sp_pieces(random.Random(0), n)
    with open(path, "wb") as f:
        f.write(chip_smoke.sp_model_bytes(pieces))


def _save_flax(params, model_dir):
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    save_params(jax.tree.map(np.asarray, params), model_dir)


def make_family_dir(base, family):
    """(model dir, words for the tables) of a tiny model of `family`."""
    from easynlp_tpu.modelzoo.models.bart.conversion import (
        convert_bart_state_dict)
    from easynlp_tpu.modelzoo.models.t5.conversion import (
        convert_t5_state_dict)

    from easynlp_tpu_torch.modelzoo.models import auto
    model_dir = os.path.join(base, "model")
    os.makedirs(model_dir)
    rng = random.Random(1)
    words = ["".join(rng.choice(LETTERS[:12]) for _ in range(rng.randint(
        2, 6))) for _ in range(40)]
    if family in ("t5", "mt5"):
        _sp_model(os.path.join(model_dir, "spiece.model"), 300)
        config = dict(T5_TINY, vocab_size=400, model_type=family)
        if family == "mt5":
            config.update(tie_word_embeddings=False,
                          feed_forward_proj="gated-gelu")
    elif family == "pegasus":
        _sp_model(os.path.join(model_dir, "spiece.model"), 300)
        config = dict(BART_TINY, vocab_size=403, model_type="pegasus")
    elif family == "randeng":
        vocab = _cjk_vocab(os.path.join(model_dir, "vocab.txt"))
        config = dict(BART_TINY, vocab_size=sum(1 for _ in open(vocab)),
                      model_type="randeng")
        words = list("中文模型生成摘要今天天气很好我们的是在了")
    else:
        n = write_transformer_tokenizer(model_dir)
        config = dict(DIALOGUE_TINY, vocab_size=n, n_positions=64,
                      model_type="transformer")
        words = ["the", "model", "then", "other", "here", "there", "thee"]
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    port_config = auto.AutoConfig.from_pretrained(model_dir)
    if family in ("t5", "mt5"):
        state = {k: v.numpy() for k, v in port_model(
            port_config).state_dict().items()}
    else:
        state = family_state_dict(port_config, seed=3)
    if family == "mt5":
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   os.path.join(model_dir, "pytorch_model.bin"))
        return model_dir, words
    from easynlp_tpu.modelzoo.models.auto.auto_factory import CONFIG_MAPPING
    jax_config = CONFIG_MAPPING[config["model_type"]]().from_pretrained(
        model_dir)
    convert = (convert_t5_state_dict if family == "t5"
               else convert_bart_state_dict)
    _save_flax(convert(state, jax_config), model_dir)
    return model_dir, words


def make_rows(path, words, n, seed, src=(6, 14), tgt=(2, 6)):
    rng = np.random.RandomState(seed)
    join = "" if len(words[0]) == 1 else " "
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            f.write("%d\t%s\t%s\n" % (
                i, join.join(rng.choice(words, rng.randint(*src))),
                join.join(rng.choice(words, rng.randint(*tgt)))))


def argv(base, family, mode, ckpt):
    app = ("open_domain_dialogue" if family == "dialogue"
           else "sequence_generation")
    common = ["--app_name=" + app, "--input_schema=" + SCHEMA,
              "--first_sequence=src", "--second_sequence=tgt",
              "--sequence_length=24", "--micro_batch_size=8",
              "--dtype=float32"]
    if mode == "train":
        return ["--mode=train", "--tables=%s/train.tsv" % base,
                "--pretrained_model_name_or_path=%s/model" % base,
                "--checkpoint_dir=" + ckpt, "--epoch_num=1",
                "--learning_rate=1e-3", "--adam_epsilon=1e-3",
                "--logging_steps=1", "--optimizer_type=AdamW"] + common
    if mode == "evaluate":
        return ["--mode=evaluate", "--tables=%s/dev.tsv" % base,
                "--checkpoint_dir=" + ckpt] + common
    return ["--mode=predict", "--tables=%s/dev.tsv" % base,
            "--outputs=%s/pred_%s.tsv" % (base, os.path.basename(ckpt)),
            "--output_schema=predictions,generated_ids", "--append_cols=id",
            "--checkpoint_dir=" + ckpt,
            "--user_defined_parameters=max_decoder_length=8 num_beams=2"
            ] + common


PORT_RUN = """
import json, sys
from easynlp_tpu_torch.appzoo.api import default_main_fn
from easynlp_tpu_torch.utils.initializer import initialize_easynlp
trainer = default_main_fn(initialize_easynlp(args_list=%r))
results = default_main_fn(initialize_easynlp(args_list=%r))
default_main_fn(initialize_easynlp(args_list=%r))
bad = [m for m in sys.modules if m in ("jax", "flax", "easynlp_tpu")
       or m.startswith("easynlp_tpu.")]
print("RESULT " + json.dumps({"steps": trainer.global_step,
                              "eval": results, "bad": bad}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{family: (base dir, the port's result)}: each family's port CLI
    train + evaluate + predict in a fresh interpreter, the five at once."""
    started = {}
    for family in FAMILIES:
        base = str(tmp_path_factory.mktemp("torch_s2s_" + family))
        _, words = make_family_dir(base, family)
        make_rows(os.path.join(base, "train.tsv"), words, 32, 1)
        make_rows(os.path.join(base, "dev.tsv"), words, 6, 2)
        ckpt = os.path.join(base, "ckpt_port")
        code = PORT_RUN % tuple(argv(base, family, mode, ckpt)
                                + ["--device=cpu"]
                                for mode in ("train", "evaluate", "predict"))
        started[family] = (subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")),
            base)
    out = {}
    for family, (proc, base) in started.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (family, stderr[-3000:])
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        out[family] = (base, json.loads(line[len("RESULT "):]))
    return out


def _events(path, kind):
    with open(os.path.join(path, "events.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


def _pred(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_trains_evaluates_and_predicts(runs, family):
    """4 steps with finite, moving losses; BLEU-4 and ROUGE-L in [0, 1];
    6 prediction rows of a start column and 7 generated ids; the config
    and tokenizer saved beside the weights; no JAX module loaded."""
    base, port = runs[family]
    assert port["bad"] == []
    assert port["steps"] == 4
    losses = [e["loss"] for e in _events(os.path.join(base, "ckpt_port"),
                                         "train")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert len({round(x, 6) for x in losses}) > 1
    assert [m for m, _ in port["eval"]] == ["bleu", "rouge_l"]
    assert all(0.0 <= x <= 1.0 for _, x in port["eval"])
    rows = _pred(os.path.join(base, "pred_ckpt_port.tsv"))
    assert [r[2] for r in rows] == [str(i) for i in range(6)]
    assert all(len(r[1].split()) == 8 for r in rows)
    ckpt = os.path.join(base, "ckpt_port")
    with open(os.path.join(ckpt, "config.json")) as f:
        assert json.load(f)["model_type"] == (
            "transformer" if family == "dialogue" else family)
    assert os.path.exists(os.path.join(ckpt, "pytorch_model.bin"))


def test_dialogue_pipeline(runs):
    """pipeline("open_domain_dialogue", model_path=<the trained
    checkpoint>) replies to each context with the CLI's predictions, the
    same texts as --mode=predict's (greedy, 8 tokens, 2 beams)."""
    from easynlp_tpu_torch.pipelines import pipeline
    base, _ = runs["dialogue"]
    reply = pipeline("open_domain_dialogue",
                     model_path=os.path.join(base, "ckpt_port"),
                     first_sequence="src", sequence_length=24,
                     dtype=torch.float32, device="cpu")
    reply.predictor.max_decode_length = 8
    reply.predictor.num_beams = 2
    with open(os.path.join(base, "dev.tsv"), encoding="utf-8") as f:
        sources = [line.split("\t")[1] for line in f]
    got = [r["predictions"] for r in reply(sources)]
    want = [r[0] for r in _pred(os.path.join(base, "pred_ckpt_port.tsv"))]
    assert got == want


def test_t5_through_both_clis(runs):
    """The JAX CLI on the same T5 directory: per-step loss, gradient norm
    and lr within rtol 1e-5 of the port's; the port evaluates the JAX
    CLI's checkpoint (flax_params.msgpack) to the BLEU and ROUGE-L of its
    own. (Generation token for token against JAX: test_torch_t5.py.)"""
    base, port = runs["t5"]
    jax_ckpt, port_ckpt = (os.path.join(base, "ckpt_" + t)
                           for t in ("jax", "port"))
    run_jax(argv(base, "t5", "train", jax_ckpt))
    train_j, train_p = _events(jax_ckpt, "train"), _events(port_ckpt,
                                                           "train")
    assert len(train_j) == len(train_p) == 4
    for ej, ep in zip(train_j, train_p):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ep[key], ej[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    # the port evaluates the JAX CLI's checkpoint as it evaluated its own
    # (the two trajectories agree within rtol 1e-5)
    got = run_port(argv(base, "t5", "evaluate", jax_ckpt))
    assert [m for m, _ in got] == [m for m, _ in port["eval"]]
    for (_, g), (_, w) in zip(got, port["eval"]):
        assert g == pytest.approx(w, abs=1e-9)


def test_gpt2_evaluate_reference_fault_23(tmp_path):
    """GPT-2 `--mode=evaluate` through both CLIs (ROADMAP reference fault
    23): JAX scores the whole generated buffer, the prompt and the pad id 0
    ("!") slots after EOS included, against the labels; the port scores
    the generated tokens up to and including EOS. The port's BLEU-4 and
    ROUGE-L equal JAX's scoring recomputed over those tokens of JAX's own
    buffers, and differ from JAX's reported ones."""
    from easynlp_tpu.appzoo.sequence_generation.evaluator import (
        bleu4, rouge_l)
    from easynlp_tpu.appzoo.sequence_generation.model import (
        SequenceGeneration as JaxApp)
    from easynlp_tpu.modelzoo.models.gpt2 import GPT2Tokenizer
    from test_torch_sequence_generation import make_model_dir, WORDS
    base = str(tmp_path)
    # 12 prompt slots and the evaluator's 64 new tokens need 76 positions
    make_model_dir(os.path.join(base, "model"), n_positions=128)
    make_rows(os.path.join(base, "dev.tsv"), WORDS, 8, 5, (2, 5), (1, 4))
    common = ["--mode=evaluate", "--app_name=sequence_generation",
              "--tables=%s/dev.tsv" % base, "--input_schema=" + SCHEMA,
              "--first_sequence=src", "--second_sequence=tgt",
              "--checkpoint_dir=%s/model" % base, "--sequence_length=12",
              "--micro_batch_size=4", "--dtype=float32"]
    want = dict(run_jax(common))
    got = dict(run_port(common))
    assert got["bleu"] != pytest.approx(want["bleu"], abs=1e-6)
    # JAX's own generation, scored over the generated part
    model_dir = os.path.join(base, "model")
    tok = GPT2Tokenizer.from_pretrained(model_dir)
    app = JaxApp.from_pretrained(model_dir, dtype=jnp.float32)
    with open(os.path.join(base, "dev.tsv")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    specials = set(tok.all_special_ids)
    eos = app.config.eos_token_id
    bleu = rouge = 0.0
    for s in range(0, len(rows), 4):
        batch = rows[s:s + 4]
        enc = tok([r[1] for r in batch], max_length=12)
        seqs = np.asarray(app.generate(jnp.asarray(enc["input_ids"]),
                                       jnp.asarray(enc["attention_mask"]),
                                       max_length=64))
        for hyp, row in zip(seqs, batch):
            new = [int(t) for t in hyp[-64:]]
            if eos in new:
                new = new[:new.index(eos) + 1]
            h = [t for t in new if t not in specials]
            ids = tok.convert_tokens_to_ids(tok.tokenize(row[2]))[:63]
            r = [t for t in ids + [eos] if t not in specials]
            bleu += bleu4(h, r)
            rouge += rouge_l(h, r)
    assert got["bleu"] == pytest.approx(bleu / len(rows), abs=1e-9)
    assert got["rouge_l"] == pytest.approx(rouge / len(rows), abs=1e-9)
