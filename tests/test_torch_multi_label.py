"""Multi-label text_classify (udp multi_label=true) in the PyTorch port
against the JAX package, at test_torch_text_match.py's tiny BERT, in f32 on
the CPU: the multi-hot dataset, the module's logits and sigmoid
cross-entropy (1e-6) and gradients (1e-5), the four metrics (1e-9), a
4-step trajectory through both CLIs (1e-5, dropout off), and predict on
the checkpoint the JAX CLI wrote (its flax_params.msgpack, read by the
port): logits within 1e-5, labels by the evaluator's rule where the JAX
predictor's differs (ROADMAP C18)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import (
    ATOL,
    WORDS,
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
    assert_trained_like_jax,
    check_parity,
    jax_params,
    make_bert_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,sent:str:1,labels:str:1"
LABELS = ["art", "food", "sport", "tech"]


def make_rows(path, n, seed):
    """Rows of 2-10 words with 1-3 space-separated labels each."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.choice(WORDS, rng.randint(2, 11))
            labels = rng.choice(LABELS, rng.randint(1, 4), replace=False)
            f.write("%d\t%s\t%s\n" % (i, " ".join(words), " ".join(labels)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_multi_label"))
    make_bert_dir(os.path.join(base, "model"),
                  heads={"classifier": len(LABELS)})
    make_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    make_rows(os.path.join(base, "dev.tsv"), 12, seed=2)
    return base


def common_argv():
    return ["--app_name=text_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=labels",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32", "--user_defined_parameters=multi_label=true"]


def test_dataset_features_match_jax(fixture_dir):
    from easynlp_tpu.appzoo.sequence_classification.data import (
        ClassificationDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.sequence_classification.data import (
        ClassificationDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="sent",
              label_name="labels", multi_label=True)
    path = os.path.join(fixture_dir, "train.tsv")
    want = JaxDataset(path, JaxTok.from_pretrained(model), **kw)
    got = ClassificationDataset(path, BertTokenizer.from_pretrained(model),
                                **kw)
    assert got.label_enumerate_values == want.label_enumerate_values \
        == LABELS
    for k in want.features:
        np.testing.assert_array_equal(got.features[k], want.features[k],
                                      err_msg=k)
    counts = got.features["label_ids"].sum(1)
    assert counts.min() == 1 and counts.max() == 3


def test_module_logits_loss_and_grads_match_jax(fixture_dir):
    """Logits and the sigmoid cross-entropy within 1e-6; gradients within
    1e-5 (check_parity)."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceMultiLabelClassification as JaxApp)
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceMultiLabelClassification, state_dict_from_jax)
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    n = len(LABELS)
    cfg, module, params = jax_params(JaxApp, config, seed=4, num_labels=n)
    tmodule = port_module(SequenceMultiLabelClassification,
                          state_dict_from_jax(params, cfg), config,
                          num_labels=n)
    rng = np.random.RandomState(5)
    ids = rng.randint(5, config["vocab_size"], (6, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 9, 5, 12, 3, 7])[:, None]
            ).astype(np.int32)
    labels = (rng.rand(6, n) < 0.4).astype(np.int32)
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": np.zeros_like(ids)}
    want = module.apply({"params": params},
                        **{k: jnp.asarray(v) for k, v in inputs.items()},
                        deterministic=True)
    with torch.no_grad():
        got = tmodule(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-6, rtol=0)
    want_loss = float(JaxApp.loss_fn(want, {"label_ids": jnp.asarray(
        labels)})["loss"])
    got_loss = SequenceMultiLabelClassification.loss_fn(
        got, {"label_ids": torch.from_numpy(labels)})["loss"].item()
    assert abs(got_loss - want_loss) <= 1e-6
    check_parity(JaxApp, SequenceMultiLabelClassification, module, params,
                 tmodule, inputs, {"label_ids": labels}, state_dict_from_jax,
                 cfg)


@pytest.mark.parametrize("case", ["random", "label-never-seen",
                                  "nothing-predicted"])
def test_metrics_match_sklearn_evaluator(case):
    """f1_micro, f1_macro, precision_micro and recall_micro against the
    JAX evaluator (scikit-learn, zero_division=0) within 1e-9."""
    from easynlp_tpu.appzoo.sequence_classification.evaluator import (
        SequenceClassificationEvaluator as JaxEvaluator)
    from easynlp_tpu_torch.appzoo.sequence_classification.evaluator import (
        multi_label_metrics)
    rng = np.random.RandomState(7)
    logits = rng.standard_normal((40, 5)).astype(np.float32)
    labels = (rng.rand(40, 5) < 0.35).astype(np.int32)
    if case == "label-never-seen":
        labels[:, 2] = 0
        logits[:, 2] = -1.0
    elif case == "nothing-predicted":
        logits[:] = -1.0
    want = JaxEvaluator.__new__(JaxEvaluator)._multi_label_metrics(logits,
                                                                   labels)
    got = multi_label_metrics(logits, labels)
    assert [m for m, _ in got] == [m for m, _ in want] == [
        "f1_micro", "f1_macro", "precision_micro", "recall_micro"]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-9, rtol=0)


def _postprocess(predictor_cls, logits):
    """predictor_cls's postprocess on a batch of logits (the softmax as the
    module's probabilities), its label names from LABELS."""
    p = predictor_cls.__new__(predictor_cls)
    p.multi_label = True
    p.id_to_label = dict(enumerate(LABELS))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return p.postprocess({"logits": logits,
                          "probabilities": e / e.sum(-1, keepdims=True),
                          "predictions": logits.argmax(-1)})


def test_multi_label_predictor_reference_fault_c18():
    """ROADMAP C18: the JAX predictor thresholds the softmax at 0.5, so no
    row ever gets two labels, while the loss is a per-label sigmoid and the
    evaluator predicts each label whose logit is above 0. The port predicts
    by the evaluator's rule (the argmax where no logit is above 0) and
    reports the per-label sigmoids."""
    from easynlp_tpu.appzoo.sequence_classification.predictor import (
        SequenceClassificationPredictor as JaxPredictor)
    from easynlp_tpu_torch.appzoo.sequence_classification.predictor import (
        SequenceClassificationPredictor)
    logits = np.array([[2.0, 1.5, -1.0, 0.5],    # three labels above 0
                       [-2.0, -0.5, -1.0, -3.0],  # none: the argmax
                       [0.1, -0.2, -0.3, -0.4]], np.float32)
    want = _postprocess(JaxPredictor, logits)
    got = _postprocess(SequenceClassificationPredictor, logits)
    assert want["predictions"] == ["art", "food", "art"]
    assert got["predictions"] == ["art food tech", "food", "art"]
    sig = [[float(x) for x in row.split()] for row in got["probabilities"]]
    np.testing.assert_allclose(sig, 1 / (1 + np.exp(-logits)), atol=1e-6)


@pytest.fixture(scope="module")
def trajectories(fixture_dir):
    """Both CLIs train 4 steps from one directory (dropout off): (JAX
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
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceMultiLabelClassification)
    jax_trainer, port, _, port_ckpt = trajectories
    assert port.global_step == jax_trainer.global_step == 4
    assert port.nonfinite_skips == 0
    assert_trained_like_jax(jax_trainer, SequenceMultiLabelClassification,
                            port_ckpt, os.path.join(fixture_dir, "model"),
                            num_labels=len(LABELS))
    with open(os.path.join(port_ckpt, "events.jsonl")) as f:
        final = [json.loads(line) for line in f][-1]
    assert set(final) >= {"f1_micro", "f1_macro", "precision_micro",
                          "recall_micro"}


def test_cli_evaluate_and_predict_on_the_jax_checkpoint(fixture_dir,
                                                       trajectories):
    """The checkpoint the JAX CLI wrote (flax_params.msgpack only): both
    CLIs' evaluate give the same metrics (1e-9 after 1e-5 logits, on
    decisions away from 0), both predicts the same logits within 1e-5;
    the port's labels are those with a logit above 0."""
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
             "--output_schema=predictions,logits", "--append_cols=id"]
            + common_argv())
    want, got = read_tsv(outs["jax"]), read_tsv(outs["port"])
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        logits = np.array(g[1].split(), float)
        np.testing.assert_allclose(logits, np.array(w[1].split(), float),
                                   atol=ATOL)
        assert g[2] == w[2]
        picked = [LABELS[j] for j in np.nonzero(logits > 0)[0]] or [
            LABELS[int(logits.argmax())]]
        assert g[0].split() == picked
        if (logits > 0).sum() <= 1:
            assert g[0] == w[0]  # where C18 does not bite


def test_cli_imports_no_jax(fixture_dir, trajectories):
    out = "%s/pred_nojax.tsv" % fixture_dir
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
        "--outputs=" + out, "--checkpoint_dir=" + trajectories[3],
        "--output_schema=predictions"] + common_argv())
    assert len(read_tsv(out)) == 12
