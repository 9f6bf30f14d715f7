"""information_extraction (Global Pointer) in the PyTorch port against the
JAX package, at test_torch_text_match.py's tiny BERT, in f32 on the CPU:
the dataset's arrays bit for bit; rope, span scores, loss and gradients
within 1e-5; the same P/R/F1 and predicted span strings on the same
scores; a 4-step trajectory through both CLIs within 1e-5 (dropout off);
and predict on the checkpoint the JAX CLI wrote (its
flax_params.msgpack, read by the port): the same span strings."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import (
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
    assert_trained_like_jax,
    check_parity,
    eval_args,
    jax_params,
    make_flax_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
    stub_forward,
)

SCHEMA = "id:str:1,content:str:1,entities:str:1"
TYPES = ["LOC", "ORG", "PER"]


def make_rows(path, n, seed):
    """Rows of 4-20 letters (longer than the 14 characters a 16-token row
    holds, so spans past the cut are dropped) with 0-3 typed spans, and a
    malformed part in the first row."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            text = "".join(rng.choice(list("abcdefgxyz"), rng.randint(4, 21)))
            spans = []
            for _ in range(rng.randint(0, 4)):
                start = rng.randint(0, len(text))
                end = min(len(text) - 1, start + rng.randint(0, 4))
                spans.append("%d,%d,%s" % (start, end, rng.choice(TYPES)))
            if i == 0:
                spans.append("7")
            f.write("%d\t%s\t%s\n" % (i, text, ";".join(spans)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from easynlp_tpu.appzoo.information_extraction.model import (
        InformationExtractionModel as JaxApp)
    base = str(tmp_path_factory.mktemp("torch_information_extraction"))
    make_flax_dir(os.path.join(base, "model"), JaxApp, seed=5,
                  num_labels=len(TYPES))
    make_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    make_rows(os.path.join(base, "dev.tsv"), 12, seed=2)
    return base


def common_argv():
    return ["--app_name=information_extraction", "--input_schema=" + SCHEMA,
            "--first_sequence=content", "--label_name=entities",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32"]


@pytest.mark.parametrize("types", [None, "PER,LOC,ORG,MISC"],
                         ids=["sorted", "given"])
def test_dataset_arrays_match_jax(fixture_dir, types):
    from easynlp_tpu.appzoo.information_extraction.data import (
        InformationExtractionDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.information_extraction.data import (
        InformationExtractionDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=16, input_schema=SCHEMA,
              first_sequence="content", label_name="entities",
              label_enumerate_values=types, multi_label=False)
    path = os.path.join(fixture_dir, "train.tsv")
    want = JaxDataset(path, JaxTok.from_pretrained(model), **kw)
    got = InformationExtractionDataset(
        path, BertTokenizer.from_pretrained(model), **kw)
    assert got.label_enumerate_values == want.label_enumerate_values
    assert got.label_mapping == want.label_mapping
    assert sorted(got.features) == sorted(want.features)
    for k, w in want.features.items():
        assert got.features[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got.features[k], w, err_msg=k)
    assert got.features["span_labels"].sum() > 10


def test_rope_matches_jax():
    from easynlp_tpu.appzoo.information_extraction.model import (
        rope as jax_rope)
    from easynlp_tpu_torch.appzoo.information_extraction.model import rope
    x = np.random.RandomState(0).standard_normal((3, 40, 2, 64)).astype(
        np.float32)
    np.testing.assert_allclose(rope(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_rope(jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def _module_inputs(vocab, n_types):
    rng = np.random.RandomState(3)
    ids = rng.randint(5, vocab, (5, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 9, 5, 12, 3])[:, None]
            ).astype(np.int32)
    labels = np.zeros((5, n_types, 12, 12), np.int8)
    for b, t, s in zip(rng.randint(0, 5, 12), rng.randint(0, n_types, 12),
                       rng.randint(1, 4, 12)):
        labels[b, t, s, s + rng.randint(0, 3)] = 1
    return ({"input_ids": ids, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids)}, {"span_labels": labels})


def test_span_scores_loss_and_grads_match_jax(fixture_dir):
    from easynlp_tpu.appzoo.information_extraction.model import (
        InformationExtractionModel as JaxApp)
    from easynlp_tpu_torch.appzoo.information_extraction.model import (
        InformationExtractionModel, state_dict_from_jax)
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    t = len(TYPES)
    cfg, module, params = jax_params(JaxApp, config, seed=2, num_labels=t)
    assert "pooler" not in params["backbone"]
    tmodule = port_module(InformationExtractionModel,
                          state_dict_from_jax(params, cfg), config,
                          num_labels=t)
    inputs, batch = _module_inputs(config["vocab_size"], t)
    want = check_parity(JaxApp, InformationExtractionModel, module, params,
                        tmodule, inputs, batch, state_dict_from_jax, cfg)
    scores = np.asarray(want["span_scores"])
    assert scores.shape == (5, t, 12, 12)
    assert (scores[4, :, 3:] == -1e30).all()      # padding rows
    assert (scores[:, :, 5, 4] == -1e30).all()    # end before start
    assert np.abs(scores[0, :, 1, 2]).max() > 1e-3


def test_evaluator_and_predictor_match_jax(fixture_dir):
    """Both evaluators and both predictors on the same span scores (the
    dev rows' gold spans, some dropped, some added): the same P/R/F1 and
    the same span strings."""
    from easynlp_tpu.appzoo.information_extraction import data as JD
    from easynlp_tpu.appzoo.information_extraction import evaluator as JE
    from easynlp_tpu.appzoo.information_extraction import predictor as JP
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.information_extraction import data as PD
    from easynlp_tpu_torch.appzoo.information_extraction import (
        evaluator as PE)
    from easynlp_tpu_torch.appzoo.information_extraction import (
        predictor as PP)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    path = os.path.join(fixture_dir, "dev.tsv")
    kw = dict(max_seq_length=16, input_schema=SCHEMA,
              first_sequence="content", label_name="entities",
              label_enumerate_values=",".join(TYPES))
    gold = PD.InformationExtractionDataset(
        path, BertTokenizer.from_pretrained(model), **kw).features
    rng = np.random.RandomState(9)
    scores = np.where(gold["span_labels"] > 0, 1.0, -1.0).astype(np.float32)
    scores[rng.rand(*scores.shape) < 0.01] = 2.0
    scores[(gold["span_labels"] > 0) & (rng.rand(*scores.shape) < 0.3)] = -2
    scores = np.concatenate([scores, scores[:3]])
    results = []
    for mod_d, mod_e, tok, torch_out in (
            (JD, JE, JaxTok, False), (PD, PE, BertTokenizer, True)):
        dataset = mod_d.InformationExtractionDataset(
            path, tok.from_pretrained(model), **kw)
        evaluator = mod_e.InformationExtractionEvaluator(dataset,
                                                         args=eval_args())
        stub_forward(evaluator, {"span_scores": scores}, torch_out)
        results.append(evaluator.evaluate(app=None))
    assert results[1] == results[0]
    assert [m for m, _ in results[1]] == ["f1", "precision", "recall"]
    assert 0 < results[1][0][1] < 1
    texts = [line.split("\t")[1] for line in open(path)]
    spans = []
    for cls in (JP.InformationExtractionPredictor,
                PP.InformationExtractionPredictor):
        p = cls.__new__(cls)
        p.id_to_type = dict(enumerate(TYPES))
        spans.append(p.postprocess({"span_scores": scores[:12],
                                    "_texts": texts})["predictions"])
    assert spans[1] == spans[0]
    assert sum(s.count(";") + bool(s) for s in spans[1]) > 10


@pytest.fixture(scope="module")
def trajectories(fixture_dir):
    """Both CLIs train 4 steps from one JAX init directory (its
    flax_params.msgpack; dropout off): (JAX
    trainer, port trainer, JAX checkpoint, port checkpoint)."""
    out = []
    for tag, run in (("jax", run_jax), ("port", run_port)):
        ckpt = os.path.join(fixture_dir, "ckpt_" + tag)
        out.append(run(["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv"
                        % (fixture_dir, fixture_dir),
                        "--pretrained_model_name_or_path=%s/model"
                        % fixture_dir, "--checkpoint_dir=" + ckpt,
                        "--epoch_num=1", "--learning_rate=1e-3",
                        "--logging_steps=1"] + common_argv()))
    return out + [os.path.join(fixture_dir, "ckpt_" + t)
                  for t in ("jax", "port")]


def test_trajectory_matches_jax(fixture_dir, trajectories):
    from easynlp_tpu_torch.appzoo.information_extraction.model import (
        InformationExtractionModel)
    jax_trainer, port, _, port_ckpt = trajectories
    assert port.global_step == jax_trainer.global_step == 4
    assert port.nonfinite_skips == 0
    assert_trained_like_jax(jax_trainer, InformationExtractionModel,
                            port_ckpt, os.path.join(fixture_dir, "model"),
                            num_labels=len(TYPES))
    losses = [r["loss"] for r in port.step_records]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cli_evaluate_and_predict_on_the_jax_checkpoint(fixture_dir,
                                                       trajectories):
    """The JAX CLI's checkpoint (flax_params.msgpack only) through both
    CLIs: the same P/R/F1 and the same span strings."""
    _, _, jax_ckpt, _ = trajectories
    assert not os.path.exists(os.path.join(jax_ckpt, "pytorch_model.bin"))
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % fixture_dir,
            "--checkpoint_dir=" + jax_ckpt] + common_argv()
    want, got = run_jax(argv), run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-9)
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "pred_%s.tsv" % tag)
        run(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
             "--outputs=" + outs[tag], "--checkpoint_dir=" + jax_ckpt,
             "--output_schema=predictions", "--append_cols=id,content"]
            + common_argv())
    want, got = read_tsv(outs["jax"]), read_tsv(outs["port"])
    assert got == want and len(got) == 12
    for pred, _, text in got:
        for span in filter(None, pred.split(";")):
            start, end, etype, chars = span.split(",")
            assert etype in TYPES
            assert text[int(start):int(end) + 1] == chars


def test_cli_imports_no_jax(fixture_dir, trajectories):
    out = "%s/pred_nojax.tsv" % fixture_dir
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
        "--outputs=" + out, "--checkpoint_dir=" + trajectories[3],
        "--output_schema=predictions"] + common_argv())
    assert len(read_tsv(out)) == 12
