"""geep_classify (GEEP early exit) in the PyTorch port against the JAX
package, at test_torch_text_match.py's tiny BERT, in f32 on the CPU: the
exits' logits within 1e-5, the exit layers and labels identical at
thresholds where no row, some rows and every row exit early, the loss
within 1e-6 of itself (relative) and gradients within 1e-5; the port's early-exit forward equal
bit for bit to its all-layers forward; a 4-step trajectory through both
CLIs within 1e-5 (dropout off); and evaluate and predict on the checkpoint
the JAX CLI wrote (its flax_params.msgpack, read by the port)."""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import (
    ATOL,
    WORDS,
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
    assert_same_tsv,
    assert_trained_like_jax,
    check_parity,
    jax_params,
    make_flax_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,sent:str:1,label:str:1"


def make_rows(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.choice(WORDS, rng.randint(2, 11))
            f.write("%d\t%s\t%s\n" % (i, " ".join(words),
                                      rng.choice(["neg", "pos"])))


def _geep_args(threshold):
    return SimpleNamespace(user_defined_parameters_dict={
        "exit_threshold": str(threshold)})


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from easynlp_tpu.appzoo.geep_classification.model import (
        GEEPClassification as JaxApp)
    base = str(tmp_path_factory.mktemp("torch_geep"))
    make_flax_dir(os.path.join(base, "model"), JaxApp, seed=6, num_labels=2)
    make_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    make_rows(os.path.join(base, "dev.tsv"), 12, seed=2)
    return base


def common_argv(threshold=0.9):
    return ["--app_name=geep_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32",
            "--user_defined_parameters=exit_threshold=%s" % threshold]


def _module_inputs(vocab):
    rng = np.random.RandomState(3)
    ids = rng.randint(5, vocab, (8, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < rng.randint(3, 13, 8)[:, None]).astype(
        np.int32)
    return ({"input_ids": ids, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids)},
            {"label_ids": rng.randint(0, 2, 8).astype(np.int32)})


@pytest.fixture(scope="module")
def modules(fixture_dir):
    """The JAX GEEP params (the head scaled by 4, so that the exits'
    confidences spread over 0.87-0.99) and the thresholds at which no row, some rows and every row
    exit before the last layer, from the JAX exits' confidences."""
    from easynlp_tpu.appzoo.geep_classification.model import (
        GEEPClassification as JaxApp)
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    cfg, module, params = jax_params(JaxApp, config, seed=2, num_labels=2)
    params["exit_head"]["kernel"] *= 4.0
    inputs, batch = _module_inputs(config["vocab_size"])
    out = module.apply({"params": params},
                       **{k: jnp.asarray(v) for k, v in inputs.items()},
                       deterministic=True)
    probs = np.asarray(out["exit_logits"])
    conf = np.exp(probs - probs.max(-1, keepdims=True))
    conf = (conf / conf.sum(-1, keepdims=True)).max(-1)   # [L, B]
    first = np.sort(conf[:-1].max(0))
    thresholds = {"none": float(conf.max()) + 1e-3,
                  "some": float((first[3] + first[4]) / 2),
                  "all": float(first[0]) - 1e-3}
    return config, cfg, params, inputs, batch, thresholds


@pytest.mark.parametrize("which", ["none", "some", "all"])
def test_exits_match_jax(modules, which):
    """At each threshold: every output of the JAX module (exit logits,
    chosen logits and probabilities within 1e-5, exit layers and labels
    identical), the loss within 1e-6 and the gradients within 1e-5; and the
    port's early-exit forward gives the all-layers forward's logits,
    probabilities, labels and exit layers bit for bit."""
    from easynlp_tpu.appzoo.geep_classification.model import (
        GEEPClassification as JaxApp)
    from easynlp_tpu_torch.appzoo.geep_classification.model import (
        GEEPClassification, state_dict_from_jax)
    config, cfg, params, inputs, batch, thresholds = modules
    args = _geep_args(thresholds[which])
    module = JaxApp.build_module(cfg, args=args, dtype=jnp.float32,
                                 num_labels=2)
    tmodule = port_module(GEEPClassification,
                          state_dict_from_jax(params, cfg), config,
                          num_labels=2, args=args)
    want = check_parity(JaxApp, GEEPClassification, module, params, tmodule,
                        inputs, batch, state_dict_from_jax, cfg)
    n_layers = config["num_hidden_layers"]
    exits = np.asarray(want["exit_layer"])
    early = (exits < n_layers - 1).sum()
    assert {"none": early == 0, "some": 0 < early < len(exits),
            "all": early == len(exits)}[which], exits
    want_loss = JaxApp.loss_fn(want, {"label_ids": jnp.asarray(
        batch["label_ids"])})
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    tmodule.eval()
    with torch.no_grad():
        full = tmodule(**tin, all_layers=True)
        early_out = tmodule(**tin)
    got_loss = GEEPClassification.loss_fn(
        full, {"label_ids": torch.from_numpy(batch["label_ids"])})
    for key in ("loss", "final_exit_loss"):
        want_value = float(want_loss[key])
        assert abs(got_loss[key].item() - want_value) <= 1e-6 * abs(
            want_value)
    for key in ("logits", "probabilities", "predictions", "exit_layer"):
        assert torch.equal(early_out[key], full[key]), key
    computed = early_out["exit_logits"].shape[0]
    assert computed == (1 if which == "all" else n_layers)
    assert torch.equal(early_out["exit_logits"],
                       full["exit_logits"][:computed])


@pytest.fixture(scope="module")
def trajectories(fixture_dir):
    """Both CLIs train 4 steps from one JAX init directory (its
    flax_params.msgpack; dropout off): (JAX trainer, port trainer, JAX
    checkpoint, port checkpoint)."""
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
    from easynlp_tpu_torch.appzoo.geep_classification.model import (
        GEEPClassification)
    jax_trainer, port, _, port_ckpt = trajectories
    assert port.global_step == jax_trainer.global_step == 4
    assert port.nonfinite_skips == 0
    assert_trained_like_jax(jax_trainer, GEEPClassification, port_ckpt,
                            os.path.join(fixture_dir, "model"), num_labels=2)
    assert all(np.isfinite(r["final_exit_loss"]) for r in port.step_records)


@pytest.mark.parametrize("threshold", [0.9, 0.5])
def test_cli_evaluate_and_predict_on_the_jax_checkpoint(fixture_dir,
                                                       trajectories,
                                                       threshold):
    """The JAX CLI's checkpoint (flax_params.msgpack only) through both
    CLIs, at the default threshold and at 0.5 (every row exits at the first
    layer): the same metrics, labels, and probabilities and logits within
    1e-5."""
    _, _, jax_ckpt, _ = trajectories
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % fixture_dir,
            "--checkpoint_dir=" + jax_ckpt] + common_argv(threshold)
    want, got = run_jax(argv), run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-9)
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "pred_%s_%s.tsv"
                                 % (tag, threshold))
        run(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
             "--outputs=" + outs[tag], "--checkpoint_dir=" + jax_ckpt,
             "--output_schema=predictions,probabilities,logits",
             "--append_cols=id"] + common_argv(threshold))
    rows = assert_same_tsv(outs["port"], outs["jax"], numeric=(1, 2))
    assert len(rows) == 12 and {r[0] for r in rows} <= {"neg", "pos"}
    assert ATOL == 1e-5


def test_cli_imports_no_jax(fixture_dir, trajectories):
    out = "%s/pred_nojax.tsv" % fixture_dir
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
        "--outputs=" + out, "--checkpoint_dir=" + trajectories[3],
        "--output_schema=predictions"] + common_argv())
    assert len(read_tsv(out)) == 12
