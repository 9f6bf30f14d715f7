"""Vanilla knowledge distillation (user_defined_parameters
enable_distillation) in the PyTorch port against the JAX package, at
test_torch_text_match.py's tiny BERT, in f32 on the CPU.

- The dataset joins the teacher logits (a text file of space-separated
  floats, or .npy) row by row into the training table only, as the JAX
  dataset does: identical features.
- 4 steps through both CLIs at the defaults (T = 1, alpha = 0.5): the
  losses within 1e-6 and the trained weights within 1e-5
  (test_torch_train.py's bounds); then the port evaluates and predicts on
  its checkpoint.
- ROADMAP reference fault 20: JAX never calls its configure, so its
  trajectory at temperature=2 alpha=0.3 is its default one bit for bit;
  the port's api configures the student, whose loss is then JAX's
  vanilla_kd_loss at T = 2, alpha = 0.3 (1e-6).
"""

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
    make_bert_dir,
    read_tsv,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,sent:str:1,label:str:1"
N_TRAIN = 32


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from make_fixtures import make_tsv
    base = str(tmp_path_factory.mktemp("torch_distillation"))
    make_bert_dir(os.path.join(base, "model"), heads={"classifier": 2})
    make_tsv(os.path.join(base, "train.tsv"), N_TRAIN, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 12, seed=2)
    logits = 2 * np.random.RandomState(4).standard_normal((N_TRAIN, 2))
    with open(os.path.join(base, "teacher.txt"), "w") as f:
        for row in logits:
            f.write("%.6f %.6f\n" % tuple(row))
    np.save(os.path.join(base, "teacher.npy"), logits.astype(np.float32))
    return base


def common_argv():
    return ["--app_name=text_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32"]


def train_argv(base, ckpt, udp=""):
    return ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv" % (base, base),
            "--pretrained_model_name_or_path=%s/model" % base,
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=1e-3", "--logging_steps=1",
            "--user_defined_parameters=enable_distillation=true "
            "logits_saved_path=%s/teacher.txt %s" % (base, udp),
            *common_argv()]


@pytest.mark.parametrize("fmt", ["txt", "npy"])
def test_dataset_joins_teacher_logits_like_jax(fixture_dir, fmt):
    from easynlp_tpu.distillation.distill_dataset import (
        DistillatoryClassificationDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.distillation.distill_dataset import (
        DistillatoryClassificationDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    udp = {"logits_saved_path": os.path.join(fixture_dir, "teacher." + fmt)}
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="sent",
              label_name="label", user_defined_parameters=udp)
    for table, training in (("train.tsv", True), ("dev.tsv", False)):
        path = os.path.join(fixture_dir, table)
        want = JaxDataset(path, JaxTok.from_pretrained(model),
                          is_training=training, **kw)
        got = DistillatoryClassificationDataset(
            path, BertTokenizer.from_pretrained(model), is_training=training,
            **kw)
        assert sorted(got.features) == sorted(want.features)
        assert ("teacher_logits" in got.features) == training
        for k in want.features:
            np.testing.assert_array_equal(got.features[k], want.features[k],
                                          err_msg=k)
    with pytest.raises(ValueError, match="teacher logits rows"):
        DistillatoryClassificationDataset(
            os.path.join(fixture_dir, "dev.tsv"),
            BertTokenizer.from_pretrained(model), is_training=True, **kw)


@pytest.fixture(scope="module")
def runs(fixture_dir):
    """{(package, udp): trainer} for the default and the T=2 runs."""
    out = {}
    for udp in ("", "temperature=2 alpha=0.3"):
        tag = "t2" if udp else "default"
        out["jax", tag] = run_jax(train_argv(
            fixture_dir, os.path.join(fixture_dir, "jax_kd_" + tag), udp))
        out["port", tag] = run_port(train_argv(
            fixture_dir, os.path.join(fixture_dir, "port_kd_" + tag), udp))
    return out


def _losses(trainer):
    with open(os.path.join(trainer.args.checkpoint_dir, "events.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f
                if json.loads(line)["kind"] == "train"]


def test_kd_trajectory_matches_jax(fixture_dir, runs):
    from easynlp_tpu_torch.distillation.distill_application import (
        DistillatorySequenceClassification)
    jax_trainer, port = runs["jax", "default"], runs["port", "default"]
    assert port.global_step == jax_trainer.global_step == 4
    np.testing.assert_allclose(_losses(port), _losses(jax_trainer),
                               atol=1e-6, rtol=0)
    assert_trained_like_jax(jax_trainer, DistillatorySequenceClassification,
                            port.args.checkpoint_dir,
                            os.path.join(fixture_dir, "model"))
    ckpt = port.args.checkpoint_dir
    results = run_port(["--mode=evaluate", "--tables=%s/dev.tsv"
                        % fixture_dir, "--checkpoint_dir=" + ckpt,
                        "--user_defined_parameters=enable_distillation=true",
                        *common_argv()])
    assert [m for m, _ in results] == ["accuracy", "f1", "auc", "mcc"]
    out = os.path.join(fixture_dir, "pred_kd.tsv")
    run_port(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
              "--outputs=" + out, "--checkpoint_dir=" + ckpt,
              "--output_schema=predictions,probabilities",
              "--user_defined_parameters=enable_distillation=true",
              *common_argv()])
    rows = read_tsv(out)
    assert len(rows) == 12 and {r[0] for r in rows} <= {"neg", "pos"}


def test_kd_settings_reference_fault_20(runs):
    from easynlp_tpu.utils import losses as jax_losses
    from easynlp_tpu_torch.distillation.distill_application import (
        DistillatorySequenceClassification)
    # JAX ignores temperature and alpha
    assert _losses(runs["jax", "t2"]) == _losses(runs["jax", "default"])
    # the port takes them
    port_t2, port_default = runs["port", "t2"], runs["port", "default"]
    assert (port_t2.app.temperature, port_t2.app.alpha) == (2.0, 0.3)
    assert (port_default.app.temperature, port_default.app.alpha) == \
        (1.0, 0.5)
    assert abs(_losses(port_t2)[0] - _losses(port_default)[0]) > 1e-3
    rng = np.random.RandomState(7)
    student = rng.standard_normal((6, 2)).astype(np.float32)
    teacher = rng.standard_normal((6, 2)).astype(np.float32)
    labels = rng.randint(0, 2, 6).astype(np.int32)
    want = float(jax_losses.vanilla_kd_loss(
        jnp.asarray(student), jnp.asarray(teacher), jnp.asarray(labels),
        temperature=2.0, alpha=0.3))
    got = port_t2.app.loss_fn(
        {"logits": torch.from_numpy(student)},
        {"teacher_logits": torch.from_numpy(teacher),
         "label_ids": torch.from_numpy(labels)})["loss"]
    assert abs(float(got) - want) <= 1e-6
    assert DistillatorySequenceClassification.temperature == 1.0  # per app


def test_kd_cli_imports_no_jax(fixture_dir):
    assert_cli_imports_no_jax(train_argv(
        fixture_dir, os.path.join(fixture_dir, "kd_nojax")))
