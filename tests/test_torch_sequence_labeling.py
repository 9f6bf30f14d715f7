"""sequence_labeling in the PyTorch port against the JAX package, at
test_torch_text_match.py's tiny BERT, in f32 on the CPU: identical features
(first-subword alignment, -100 on continuation pieces, [CLS], [SEP] and
padding; space-separated tokens or characters), module outputs, loss and
gradients within 1e-5, the same BIO-span metrics on the same predictions,
and, from the port's trained checkpoint, the same evaluate metrics and
predicted tags through both CLIs."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_text_match import (
    WORDS,
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
    assert_same_tsv,
    check_parity,
    eval_args,
    jax_params,
    make_bert_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
    stub_forward,
)

SCHEMA = "id:str:1,content:str:1,tags:str:1"
TAGS = ["O", "B-PER", "I-PER", "B-LOC", "I-LOC"]


def make_rows(path, n, seed):
    """Rows of space-separated words (some split into several WordPiece
    pieces, one unknown) with BIO tags, and a few rows of letters with no
    space (tokenised character by character)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            if i % 5 == 4:
                words = list("".join(rng.choice(list("abcdefg"),
                                                rng.randint(3, 9))))
                text = "".join(words)
            else:
                words = list(rng.choice(WORDS + ["awfulday", "goodtime"],
                                        rng.randint(2, 11)))
                text = " ".join(words)
            tags, prev = [], "O"
            for _ in words:
                r = rng.rand()
                if prev != "O" and r < 0.4:
                    tag = "I-" + prev[2:]
                elif r < 0.7:
                    tag = "O"
                else:
                    tag = rng.choice(["B-PER", "B-LOC"])
                tags.append(tag)
                prev = tag
            tags[0] = "B-PER" if i == 0 else tags[0]
            f.write("%d\t%s\t%s\n" % (i, text, " ".join(tags)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_sequence_labeling"))
    make_bert_dir(os.path.join(base, "model"),
                  heads={"classifier": len(TAGS)})
    make_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    make_rows(os.path.join(base, "dev.tsv"), 10, seed=2)
    return base


def common_argv():
    return ["--app_name=sequence_labeling", "--input_schema=" + SCHEMA,
            "--first_sequence=content", "--label_name=tags",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32"]


@pytest.mark.parametrize("labels", [None, ",".join(TAGS)],
                         ids=["sorted", "given"])
def test_dataset_features_match_jax(fixture_dir, labels):
    from easynlp_tpu.appzoo.sequence_labeling.data import (
        SequenceLabelingDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.sequence_labeling.data import (
        SequenceLabelingDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=12, input_schema=SCHEMA,
              first_sequence="content", label_name="tags",
              label_enumerate_values=labels)
    path = os.path.join(fixture_dir, "train.tsv")
    want = JaxDataset(path, JaxTok.from_pretrained(model), **kw)
    got = SequenceLabelingDataset(path, BertTokenizer.from_pretrained(model),
                                  **kw)
    assert got.label_enumerate_values == want.label_enumerate_values == (
        TAGS if labels else sorted(TAGS))
    assert sorted(got.features) == sorted(want.features)
    for k in want.features:
        np.testing.assert_array_equal(got.features[k], want.features[k],
                                      err_msg=k)
    ids, lab = got.features["input_ids"], got.features["label_ids"]
    assert (lab[:, 0] == -100).all()  # [CLS]
    assert ((lab == -100) & (got.features["attention_mask"] == 1)
            & (ids != 102) & (ids != 101)).any()  # continuation pieces


def test_module_loss_and_grads_match_jax(fixture_dir):
    from easynlp_tpu.appzoo.sequence_labeling.model import (
        SequenceLabeling as JaxApp)
    from easynlp_tpu_torch.appzoo.sequence_labeling.model import (
        SequenceLabeling, state_dict_from_jax)
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    n = len(TAGS)
    cfg, module, params = jax_params(JaxApp, config, seed=2, num_labels=n)
    assert "pooler" not in params["backbone"]
    tmodule = port_module(SequenceLabeling, state_dict_from_jax(params, cfg),
                          config, num_labels=n)
    rng = np.random.RandomState(3)
    ids = rng.randint(5, config["vocab_size"], (5, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 9, 5, 12, 3])[:, None]
            ).astype(np.int32)
    labels = rng.randint(0, n, (5, 12)).astype(np.int32)
    labels[mask == 0] = -100
    labels[:, 0] = -100
    labels[rng.rand(5, 12) < 0.2] = -100
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": np.zeros_like(ids)}
    check_parity(JaxApp, SequenceLabeling, module, params, tmodule, inputs,
                 {"label_ids": labels}, state_dict_from_jax, cfg)


def test_evaluator_matches_jax(fixture_dir):
    """Both evaluators over the dev set fed the same per-token predictions
    (gold tags with a quarter of the positions redrawn): the same F1,
    precision, recall and accuracy; and bio_spans agrees on edge cases."""
    from easynlp_tpu.appzoo.sequence_labeling import data as JD
    from easynlp_tpu.appzoo.sequence_labeling import evaluator as JE
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.sequence_labeling import data as PD
    from easynlp_tpu_torch.appzoo.sequence_labeling import evaluator as PE
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=16, input_schema=SCHEMA,
              first_sequence="content", label_name="tags",
              label_enumerate_values=",".join(TAGS))
    path = os.path.join(fixture_dir, "dev.tsv")
    gold = PD.SequenceLabelingDataset(
        path, BertTokenizer.from_pretrained(model), **kw).features["label_ids"]
    rng = np.random.RandomState(9)
    preds = np.where(gold >= 0, gold, 0)
    flip = rng.rand(*preds.shape) < 0.25
    preds[flip] = rng.randint(0, len(TAGS), int(flip.sum()))
    preds = np.concatenate([preds, preds[:2]]).astype(np.int64)
    results = []
    for mod_d, mod_e, tok, torch_out in (
            (JD, JE, JaxTok, False), (PD, PE, BertTokenizer, True)):
        dataset = mod_d.SequenceLabelingDataset(
            path, tok.from_pretrained(model), **kw)
        evaluator = mod_e.SequenceLabelingEvaluator(dataset,
                                                    args=eval_args())
        stub_forward(evaluator, {"predictions": preds}, torch_out)
        results.append(evaluator.evaluate(app=None))
    want, got = results
    assert [m for m, _ in got] == [m for m, _ in want] == [
        "f1", "precision", "recall", "accuracy"]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-12)
    assert 0 < dict(got)["f1"] < 1
    for tags in (["B-A", "I-A", "I-B", "B-B"], ["I-A", "I-A"], [],
                 ["B-A", "O", "B-A", "I-A", "I-A"]):
        assert PE.bio_spans(tags) == JE.bio_spans(tags)


@pytest.fixture(scope="module")
def trained(fixture_dir):
    ckpt = os.path.join(fixture_dir, "ckpt")
    trainer = run_port(["--mode=train",
                        "--tables=%s/train.tsv,%s/dev.tsv"
                        % (fixture_dir, fixture_dir),
                        "--pretrained_model_name_or_path=%s/model"
                        % fixture_dir, "--checkpoint_dir=" + ckpt,
                        "--epoch_num=1", "--learning_rate=1e-3",
                        "--logging_steps=1"] + common_argv())
    assert trainer.global_step == 4 and trainer.nonfinite_skips == 0
    assert trainer.app.module.classifier.out_features == len(TAGS)
    with open(os.path.join(ckpt, "label_mapping.json")) as f:
        assert json.load(f) == {t: i for i, t in enumerate(sorted(TAGS))}
    return ckpt


def test_cli_evaluate_and_predict_match_jax(fixture_dir, trained):
    """From the port's checkpoint (bert.* without pooler, classifier.*,
    label_mapping.json): the same metrics through both CLIs' evaluate, and
    the same tags, one per whole source token, through both predicts."""
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % fixture_dir,
            "--checkpoint_dir=" + trained] + common_argv()
    want, got = run_jax(argv), run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-9)
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "pred_%s.tsv" % tag)
        run(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
             "--outputs=" + outs[tag], "--checkpoint_dir=" + trained,
             "--output_schema=predictions", "--append_cols=content,id"]
            + common_argv())
    rows = assert_same_tsv(outs["port"], outs["jax"])
    assert [r[2] for r in rows] == [str(i) for i in range(10)]
    assert all(set(r[0].split()) <= set(TAGS) for r in rows)


def test_cli_imports_no_jax(fixture_dir, trained):
    out = "%s/pred_nojax.tsv" % fixture_dir
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
        "--outputs=" + out, "--checkpoint_dir=" + trained,
        "--output_schema=predictions"] + common_argv())
    assert len(read_tsv(out)) == 10
