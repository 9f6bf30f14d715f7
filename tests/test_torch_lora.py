"""LoRA (user_defined_parameters enable_lora) in the PyTorch port against
the JAX package, at test_torch_text_match.py's tiny BERT, in f32 on the CPU.

- lora_apply on per-layer weights (the query and value kernels sliced from
  the JAX model's stacked [L, E, 3E] qkv kernel; a GPT-2 Conv1D weight,
  whose [in, out] layout takes no transpose) against the JAX lora_apply on
  the same 2-D kernels and adapters: 1e-6 (one f32 rank-4 product and an
  add).
- A 4-step trajectory through both CLIs with lora_targets=classifier (a
  2-D leaf in both packages), the port starting from the JAX package's
  initial adapters: the losses within 1e-6, the trained adapters and the
  merged weights within 1e-5 (test_torch_train.py's bound for trained
  parameters); the base stays bit-identical and the adapters move.
- The merged pytorch_model.bin, loaded as a plain text_classify
  checkpoint, predicts the live model's logits (1e-5; the merged weight
  is one f32 rounding away from base + delta); load_adapter on a freshly
  loaded base gives them bit for bit.
- Resume restores the base and the adapters: a run resumed after step 2
  ends where the uninterrupted one ends (1e-7).
- ROADMAP reference fault 19: JAX's match_report on the text_classify BERT
  is [] (its scanned kernels are 3-D, its projection is named qkv); the
  port's holds the 3 x L query/key/value weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import (
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
    jax_params,
    make_bert_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,sent:str:1,label:str:1"


def _config(fixture_dir):
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from make_fixtures import make_tsv
    base = str(tmp_path_factory.mktemp("torch_lora"))
    make_bert_dir(os.path.join(base, "model"), heads={"classifier": 2})
    make_tsv(os.path.join(base, "train.tsv"), 32, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 12, seed=2)
    return base


def common_argv():
    return ["--app_name=text_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32"]


def train_argv(base, ckpt, udp, *extra):
    return ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv" % (base, base),
            "--pretrained_model_name_or_path=%s/model" % base,
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=1e-2", "--logging_steps=1",
            "--user_defined_parameters=" + udp, *common_argv(), *extra]


def test_lora_apply_matches_jax_on_per_layer_kernels(fixture_dir):
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassification as JaxApp)
    from easynlp_tpu.modelzoo import lora as jax_lora
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, state_dict_from_jax)
    from easynlp_tpu_torch.modelzoo import lora
    from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import Conv1D
    config = _config(fixture_dir)
    cfg, _, params = jax_params(JaxApp, config, seed=2)
    tmodule = port_module(SequenceClassification,
                          state_dict_from_jax(params, cfg), config)
    e, rng = config["hidden_size"], np.random.RandomState(3)
    qkv = params["backbone"]["encoder"]["layers"]["attention"]["qkv"]
    kernels, names = {}, {}
    for i in range(config["num_hidden_layers"]):
        for j, proj in ((0, "query"), (2, "value")):
            key = "%s_%d" % (proj, i)
            kernels[key] = jnp.asarray(qkv["kernel"][i][:, j * e:(j + 1) * e])
            names[key] = "backbone.encoder.layer.%d.attention.self.%s.weight" \
                % (i, proj)
    conv = torch.nn.Module()
    conv.c_attn = Conv1D(e, 3 * e)
    torch.nn.init.normal_(conv.c_attn.weight)
    kernels["c_attn"] = jnp.asarray(conv.c_attn.weight.detach().numpy())
    names["c_attn"] = "c_attn.weight"
    adapters = jax_lora.lora_init(kernels, rank=4,
                                  targets=("query", "value", "c_attn"))
    adapters = {k: {"a": ad["a"], "b": jnp.asarray(rng.standard_normal(
        ad["b"].shape).astype(np.float32))} for k, ad in adapters.items()}
    want = jax_lora.lora_apply(kernels, adapters, 0.5)
    for key, name in names.items():
        module = conv if key == "c_attn" else tmodule
        ad = {name: {"a": torch.from_numpy(np.array(adapters[key]["a"])),
                     "b": torch.from_numpy(np.array(adapters[key]["b"]))}}
        got = lora.lora_apply(module, dict(module.named_parameters()), ad,
                              0.5)[name]
        w = np.asarray(want[key])
        np.testing.assert_allclose(
            got.detach().numpy(), w if key == "c_attn" else w.T, atol=1e-6,
            rtol=0, err_msg=key)


def test_match_report_reference_fault_19(fixture_dir):
    """JAX's default targets adapt nothing of its scanned BERT; the port's
    adapt each layer's query, key and value."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassification as JaxApp)
    from easynlp_tpu.modelzoo import lora as jax_lora
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, state_dict_from_jax)
    from easynlp_tpu_torch.modelzoo import lora
    config = _config(fixture_dir)
    cfg, _, params = jax_params(JaxApp, config)
    assert jax_lora.match_report(params) == []
    tmodule = port_module(SequenceClassification,
                          state_dict_from_jax(params, cfg), config)
    assert lora.match_report(tmodule) == [
        "backbone.encoder.layer.%d.attention.self.%s.weight" % (i, proj)
        for i in range(config["num_hidden_layers"])
        for proj in ("query", "key", "value")]
    assert lora.parse_targets("") == lora.DEFAULT_TARGETS \
        == jax_lora.DEFAULT_TARGETS
    assert lora.parse_targets(" query, value ") == ("query", "value")


def _jax_initial_adapters(fixture_dir, targets):
    """The adapters the JAX CLI's LoRAApplication starts from (its
    lora_init at seed 0 on the app's params)."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassification as JaxApp)
    from easynlp_tpu.modelzoo import lora as jax_lora
    app = JaxApp.from_pretrained(os.path.join(fixture_dir, "model"),
                                 dtype=jnp.float32, num_labels=2)
    return jax_lora.lora_init(app.params, rank=4, targets=targets, seed=0)


@pytest.fixture(scope="module")
def trajectories(fixture_dir):
    """Both CLIs, 4 steps of enable_lora with lora_targets=classifier, the
    port starting from JAX's initial adapters; (jax trainer, port trainer,
    port checkpoint)."""
    from easynlp_tpu_torch.core import lora_app
    udp = "enable_lora=true lora_targets=classifier lora_alpha=8"
    start = _jax_initial_adapters(fixture_dir, ("classifier",))
    a = torch.from_numpy(np.array(start["classifier"]["kernel"]["a"]))

    def carried(module, rank, targets, seed):
        assert targets == ("classifier",) and rank == 4
        return {"classifier.weight": {
            "a": torch.nn.Parameter(a.clone()),
            "b": torch.nn.Parameter(torch.zeros(4, 2))}}

    jax_trainer = run_jax(train_argv(fixture_dir,
                                     os.path.join(fixture_dir, "jax_lora"),
                                     udp))
    mp = pytest.MonkeyPatch()
    mp.setattr(lora_app, "lora_init", carried)
    try:
        ckpt = os.path.join(fixture_dir, "port_lora")
        port = run_port(train_argv(fixture_dir, ckpt, udp))
    finally:
        mp.undo()
    return jax_trainer, port, ckpt


def test_lora_trajectory_matches_jax(fixture_dir, trajectories):
    from easynlp_tpu.modelzoo.modeling_utils import load_params
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        state_dict_from_jax)
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    jax_trainer, port, ckpt = trajectories
    assert port.global_step == jax_trainer.global_step == 4
    assert port.param_names == ["lora_a.0", "lora_b.0"]
    events = {}
    for tag, path in (("jax", jax_trainer.args.checkpoint_dir),
                      ("port", ckpt)):
        with open(os.path.join(path, "events.jsonl")) as f:
            events[tag] = [json.loads(line) for line in f
                           if json.loads(line)["kind"] == "train"]
    for ej, ep in zip(events["jax"], events["port"]):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ep[key], ej[key], atol=1e-6,
                                       rtol=1e-5, err_msg=key)
    # the adapters
    jax_ad = load_params(jax_trainer.args.checkpoint_dir,
                         target=jax.device_get(jax_trainer.params["lora"]),
                         name="flax_params_lora.msgpack")["classifier"][
        "kernel"]
    got = torch.load(os.path.join(ckpt, "pytorch_model_lora.bin"),
                     weights_only=True)
    assert sorted(got) == ["classifier.weight.lora_a",
                           "classifier.weight.lora_b"]
    for part in ("a", "b"):
        np.testing.assert_allclose(got["classifier.weight.lora_" + part],
                                   np.asarray(jax_ad[part]), atol=1e-5,
                                   rtol=0)
    assert float(got["classifier.weight.lora_b"].abs().max()) > 1e-3
    # the merged weights against the JAX checkpoint's
    config = BertConfig.from_pretrained(ckpt)
    jax_merged = load_params(jax_trainer.args.checkpoint_dir,
                             target=jax.device_get(
                                 jax_trainer.params["base"]))
    want = {k.replace("backbone.", "bert.", 1): v for k, v in
            state_dict_from_jax(jax.tree.map(np.asarray, jax_merged),
                                config).items()}
    merged = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                        weights_only=True)
    assert set(merged) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(merged[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    # the base, bit for bit
    init = torch.load(os.path.join(fixture_dir, "model", "pytorch_model.bin"),
                      weights_only=True)
    base = torch.load(os.path.join(ckpt, "pytorch_model_base.bin"),
                      weights_only=True)
    assert set(base) == set(merged)
    for k, v in base.items():
        assert torch.equal(v, init[k]), k
    assert not torch.equal(merged["classifier.weight"],
                           init["classifier.weight"])
    assert torch.equal(merged["bert.pooler.dense.weight"],
                       init["bert.pooler.dense.weight"])


def test_merged_checkpoint_predicts_the_live_model(fixture_dir,
                                                   trajectories):
    """--mode=predict on the LoRA checkpoint (a plain text_classify one to
    the predictor) against the trained LoRA app's own forward, which
    merges the adapters on the fly."""
    from easynlp_tpu_torch.appzoo.sequence_classification.data import (
        ClassificationDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    _, port, ckpt = trajectories
    out = os.path.join(fixture_dir, "pred_lora.tsv")
    run_port(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
              "--outputs=" + out, "--checkpoint_dir=" + ckpt,
              "--output_schema=predictions,logits", *common_argv()])
    got = np.array([[float(x) for x in row[1].split()]
                    for row in read_tsv(out)])
    ds = ClassificationDataset(
        os.path.join(fixture_dir, "dev.tsv"),
        BertTokenizer.from_pretrained(ckpt), max_seq_length=16,
        input_schema=SCHEMA, first_sequence="sent", label_name="label")
    port.app.module.eval()
    with torch.no_grad():
        live = port.app.forward({k: torch.from_numpy(v)
                                 for k, v in ds.features.items()})
    np.testing.assert_allclose(got, live["logits"].numpy(), atol=1e-5,
                               rtol=0)
    # the adapters alone, attached to a freshly loaded base
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.core.lora_app import LoRAApplication
    base = SequenceClassification.from_pretrained(
        os.path.join(fixture_dir, "model"), device="cpu", num_labels=2)
    attached = LoRAApplication.load_adapter(base, ckpt, rank=4, alpha=8,
                                            targets=("classifier",))
    attached.module.eval()
    with torch.no_grad():
        again = attached.forward({k: torch.from_numpy(v)
                                  for k, v in ds.features.items()})
    assert torch.equal(again["logits"], live["logits"])


def test_lora_resume_restores_base_and_adapters(fixture_dir):
    udp = "enable_lora=true lora_rank=2"
    full = os.path.join(fixture_dir, "lora_resume_full")
    run_port(train_argv(fixture_dir, full, udp, "--save_checkpoint_steps=2",
                        "--save_all_checkpoints"))
    tail = os.path.join(fixture_dir, "lora_resume_tail")
    trainer = run_port(train_argv(fixture_dir, tail, udp,
                                  "--resume_from_checkpoint=%s/step_2"
                                  % full))
    assert [r["step"] for r in trainer.step_records] == [3, 4]
    for name in ("pytorch_model_lora.bin", "pytorch_model_base.bin",
                 "pytorch_model.bin"):
        a = torch.load(os.path.join(full, name), weights_only=True)
        b = torch.load(os.path.join(tail, name), weights_only=True)
        assert set(a) == set(b)
        for k in a:
            torch.testing.assert_close(b[k], a[k], atol=1e-7, rtol=0)
    lora = torch.load(os.path.join(full, "pytorch_model_lora.bin"),
                      weights_only=True)
    # the default targets: each layer's query, key and value
    assert len(lora) == 2 * 3 * 2


def test_lora_with_remat_is_refused(fixture_dir):
    """--remat with enable_lora was refused until the recompute could read
    the merged weights; it now trains, and --remat=full gives the losses
    and adapters of --remat=none bit for bit (the name is kept;
    test_torch_knowledge.py::test_lora_trains_under_remat_bit_for_bit
    holds selective and adapters inside the checkpointed regions too)."""
    runs = {}
    for policy in ("none", "full"):
        ckpt = os.path.join(fixture_dir, "lora_remat_" + policy)
        trainer = run_port(train_argv(fixture_dir, ckpt, "enable_lora=true",
                                      "--remat=" + policy))
        runs[policy] = ([r["loss"] for r in trainer.step_records],
                        torch.load(os.path.join(ckpt,
                                                "pytorch_model_lora.bin"),
                                   weights_only=True))
    assert runs["full"][0] == runs["none"][0]
    assert len(runs["none"][0]) == 4
    for k, v in runs["none"][1].items():
        assert torch.equal(runs["full"][1][k], v), k


def test_lora_cli_imports_no_jax(fixture_dir):
    assert_cli_imports_no_jax(train_argv(
        fixture_dir, os.path.join(fixture_dir, "lora_nojax"),
        "enable_lora=true"))
    assert os.path.exists(os.path.join(fixture_dir, "lora_nojax",
                                       "pytorch_model_lora.bin"))
