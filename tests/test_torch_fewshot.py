"""Few-shot PET / CPT (user_defined_parameters enable_fewshot;
CPTClassification) in the PyTorch port against the JAX package, at
test_torch_text_match.py's tiny BERT with the MLM head, in f32 on the CPU.

- PET featurisation: identical input_ids, attention_mask, mask_positions,
  verbalizer_ids and labels, the cut to a short sequence length included.
- The module from one JAX init carried over by mlm_state_dict_from_jax: the
  class logits (the MLM logits at [MASK], gathered at the verbalizer's
  token ids) and every other output within 1e-5, the CE and CPT losses and
  their gradients within 1e-5 (test_torch_text_match.check_parity).
- 4 PET steps through both CLIs from a JAX flax_params.msgpack: the losses
  within 1e-6 and the trained weights within 1e-5 (test_torch_train.py's
  bounds); then the port's --mode=evaluate and --mode=predict on its
  checkpoint, whose train_config.json carries the pattern and verbalizer,
  and the JAX CLI's predict on the same checkpoint: the same labels, the
  probabilities within 1e-5.
"""

import json
import os

import numpy as np
import pytest

from test_torch_text_match import (
    ATOL,
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
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
PATTERN = "{sent1},it,was,{mask}"
UDP = "enable_fewshot=true pattern=%s label_desc=awful,great" % PATTERN


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from make_fixtures import make_tsv

    from easynlp_tpu.fewshot_learning.fewshot_application import (
        FewshotClassification)
    base = str(tmp_path_factory.mktemp("torch_fewshot"))
    make_flax_dir(os.path.join(base, "model"), FewshotClassification)
    make_tsv(os.path.join(base, "train.tsv"), 32, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 12, seed=2)
    return base


def _config(fixture_dir):
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("pattern,label_desc,max_len", [
    (PATTERN, "awful,great", 16),
    ("{sent1}{mask}", None, 16),                 # the label names' tokens
    ("it,was,{mask},{sent1},very,good", "bad,good", 8),  # cut
])
def test_featurisation_matches_jax(fixture_dir, pattern, label_desc,
                                   max_len):
    from easynlp_tpu.fewshot_learning.fewshot_dataset import (
        FewshotDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.fewshot_learning.fewshot_dataset import (
        FewshotDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    path = os.path.join(fixture_dir, "train.tsv")
    udp = {"pattern": pattern}
    if label_desc:
        udp["label_desc"] = label_desc
    kw = dict(max_seq_length=max_len, input_schema=SCHEMA,
              first_sequence="sent", label_name="label",
              user_defined_parameters=udp)
    want = JaxDataset(path, JaxTok.from_pretrained(model), **kw)
    got = FewshotDataset(path, BertTokenizer.from_pretrained(model), **kw)
    assert got.label_enumerate_values == want.label_enumerate_values
    assert sorted(got.features) == sorted(want.features)
    for k in want.features:
        np.testing.assert_array_equal(got.features[k], want.features[k],
                                      err_msg=k)
    ids = got.features["input_ids"]
    rows = np.arange(len(ids))
    assert (ids[rows, got.features["mask_positions"]] ==
            got.tokenizer.mask_token_id).all()


@pytest.mark.parametrize("app", ["FewshotClassification",
                                 "CPTClassification"])
def test_module_logits_losses_and_grads_match_jax(fixture_dir, app):
    from easynlp_tpu.fewshot_learning import fewshot_application as J
    from easynlp_tpu_torch.fewshot_learning import fewshot_application as P
    jax_app, port_app = getattr(J, app), getattr(P, app)
    config = _config(fixture_dir)
    cfg, module, params = jax_params(jax_app, config, seed=5)
    tmodule = port_module(port_app, port_app.state_dict_from_jax(params, cfg),
                          config)
    rng = np.random.RandomState(6)
    ids = rng.randint(5, config["vocab_size"], (6, 12)).astype(np.int32)
    lengths = np.array([12, 9, 5, 12, 7, 10])
    mask = (np.arange(12)[None] < lengths[:, None]).astype(np.int32)
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": np.zeros_like(ids),
              "mask_positions": (lengths - 2).astype(np.int32),
              "verbalizer_ids": np.tile(np.array([[7, 12]], np.int32),
                                        (6, 1))}
    batch = {"label_ids": np.array([0, 1, 1, 0, 1, 0], np.int32)}
    want = check_parity(jax_app, port_app, module, params, tmodule, inputs,
                        batch, port_app.state_dict_from_jax, tmodule.config)
    assert np.asarray(want["logits"]).shape == (6, 2)
    if app == "CPTClassification":
        import jax.numpy as jnp
        import torch
        out = module.apply({"params": params},
                           **{k: jnp.asarray(v) for k, v in inputs.items()},
                           deterministic=True)
        jl = J.CPTClassification.loss_fn(out, {"label_ids": jnp.asarray(
            batch["label_ids"])})
        with torch.no_grad():
            got = tmodule(**{k: torch.from_numpy(v)
                             for k, v in inputs.items()})
        pl = P.CPTClassification.loss_fn(got, {"label_ids": torch.from_numpy(
            batch["label_ids"])})
        for k in ("ce_loss", "cl_loss"):
            assert abs(float(jl[k]) - float(pl[k])) <= ATOL, k
        assert float(pl["cl_loss"]) > 0


def _argv(base, *extra):
    return ["--app_name=text_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32", *extra]


def _train_argv(base, ckpt):
    return ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv" % (base, base),
            "--pretrained_model_name_or_path=%s/model" % base,
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=1e-3", "--logging_steps=1",
            *_argv(base, "--user_defined_parameters=" + UDP)]


def test_pet_cli_train_predict_round_trip(fixture_dir):
    from easynlp_tpu_torch.fewshot_learning.fewshot_application import (
        FewshotClassification)
    jax_trainer = run_jax(_train_argv(fixture_dir,
                                      os.path.join(fixture_dir, "jax_pet")))
    ckpt = os.path.join(fixture_dir, "port_pet")
    port = run_port(_train_argv(fixture_dir, ckpt))
    assert port.global_step == jax_trainer.global_step == 4
    losses = {}
    for tag, path in (("jax", jax_trainer.args.checkpoint_dir),
                      ("port", ckpt)):
        with open(os.path.join(path, "events.jsonl")) as f:
            losses[tag] = [json.loads(line)["loss"] for line in f
                           if json.loads(line)["kind"] == "train"]
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-6,
                               rtol=0)
    assert_trained_like_jax(jax_trainer, FewshotClassification, ckpt,
                            os.path.join(fixture_dir, "model"))
    with open(os.path.join(ckpt, "train_config.json")) as f:
        assert PATTERN in json.load(f)["user_defined_parameters"]
    # evaluate and predict name only the switch: the predictor reads the
    # pattern and the verbalizer back from train_config.json
    switch = "--user_defined_parameters=enable_fewshot=true"
    results = run_port(["--mode=evaluate", "--tables=%s/dev.tsv"
                        % fixture_dir, "--checkpoint_dir=" + ckpt,
                        *_argv(fixture_dir, "--user_defined_parameters="
                               + UDP)])
    assert [m for m, _ in results][:2] == ["accuracy", "f1"]
    outs = {}
    for tag, run in (("port", run_port), ("jax", run_jax)):
        outs[tag] = os.path.join(fixture_dir, "pred_pet_%s.tsv" % tag)
        run(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
             "--outputs=" + outs[tag], "--checkpoint_dir=" + ckpt,
             "--output_schema=predictions,probabilities",
             *_argv(fixture_dir, switch)])
    got, want = read_tsv(outs["port"]), read_tsv(outs["jax"])
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[0] in ("neg", "pos")
        np.testing.assert_allclose(np.array(g[1].split(), float),
                                   np.array(w[1].split(), float),
                                   atol=ATOL, rtol=0)


def test_pet_cli_imports_no_jax(fixture_dir):
    assert_cli_imports_no_jax(_train_argv(
        fixture_dir, os.path.join(fixture_dir, "pet_nojax")))
