"""text_match, cross-encoder and two-tower, in the PyTorch port against the
JAX package; also the helpers the port's other BERT app tests share
(test_torch_sequence_labeling.py, test_torch_mrc.py,
test_torch_vectorization.py).

A tiny BERT (2 layers, width 32, 4 heads, dropout 0, the fixtures'
WordPiece vocabulary) runs in f32 on the CPU on both sides:
- the datasets give identical features on one TSV;
- modules built from one JAX init (every leaf moved by seeded noise, so
  biases and LayerNorms are exercised) and carried over by the module's
  `state_dict_from_jax` give outputs and losses within 1e-5, and gradients
  within 1e-5 of jax.grad's (f32 in two frameworks, summed in other
  orders; the values are O(1));
- the evaluators give the same metrics on the same predictions (1e-12);
- the port's CLI trains on a model directory with HF-named numpy weights,
  and both CLIs evaluate and predict from the port's checkpoint: the same
  metrics and the same output TSV (labels exactly, numbers within 1e-5).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import (  # noqa: E402
    FILLER,
    NEG_WORDS,
    POS_WORDS,
    make_pretrained,
)
from test_torch_text_classify import write_weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
ATOL = 1e-5
WORDS = FILLER + POS_WORDS + NEG_WORDS + ["unseenword"]


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def make_bert_dir(model_dir, heads=None, seed=0):
    """A tiny BERT model directory: the fixtures' vocab.txt, TINY's
    config.json, HF-named weights from a numpy seed (`bert.` prefix, pooler
    included) and a `<name>.weight/.bias` head for each {name: n_out} in
    heads (std 0.2, so the random model's decisions have margins)."""
    make_pretrained(model_dir)
    path = os.path.join(model_dir, "config.json")
    with open(path) as f:
        config = dict(json.load(f), **TINY)
    with open(path, "w") as f:
        json.dump(config, f)
    write_weights(model_dir, seed)
    weights = os.path.join(model_dir, "pytorch_model.bin")
    state = torch.load(weights, weights_only=True)
    del state["classifier.weight"], state["classifier.bias"]
    rng = np.random.RandomState(seed + 1)
    for name, n in (heads or {}).items():
        state[name + ".weight"] = torch.from_numpy(
            (0.2 * rng.standard_normal((n, config["hidden_size"]))).astype(
                np.float32))
        state[name + ".bias"] = torch.from_numpy(
            (0.1 * rng.standard_normal(n)).astype(np.float32))
    torch.save(state, weights)
    os.remove(os.path.join(model_dir, "label_mapping.json"))
    return config


def jax_params(jax_app, config, seed=0, **build_kw):
    """(JAX config, module, params) of the JAX app `jax_app` at TINY widths:
    its own init, then every leaf moved by 0.05 N(0, 1) noise."""
    from easynlp_tpu.modelzoo.models.bert import BertConfig as JaxBertConfig
    cfg = JaxBertConfig(**config)
    module = jax_app.build_module(cfg, dtype=jnp.float32, **build_kw)
    params = jax_app.init_params(module, cfg, seed)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
    return cfg, module, params


def make_flax_dir(model_dir, jax_app, heads=None, seed=0, **build_kw):
    """make_bert_dir's directory holding the JAX app's own init (moved by
    jax_params' noise) as flax_params.msgpack in place of
    pytorch_model.bin: both packages then start from the same weights,
    heads included (the JAX apps' pytorch conversion drops some heads, and
    the two frameworks draw other inits). Returns the params."""
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    config = make_bert_dir(model_dir, heads=heads)
    os.remove(os.path.join(model_dir, "pytorch_model.bin"))
    _, _, params = jax_params(jax_app, config, seed=seed, **build_kw)
    save_params(params, model_dir)
    return params


def port_module(port_app, state_dict, config, **build_kw):
    """The port app's module at the same widths, in f32 on the CPU, with
    `state_dict` loaded strictly."""
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    module = port_app.build_module(BertConfig(**config), dtype=torch.float32,
                                   device="cpu", **build_kw)
    module.load_state_dict(state_dict, strict=True)
    return module


def check_parity(jax_app, port_app, module, params, tmodule, inputs, batch,
                 state_dict_from_jax, config):
    """Outputs, loss and gradients of the JAX module and the port's on the
    same numpy inputs: float outputs and the loss within ATOL, integer ones
    equal, and each parameter's gradient within ATOL of jax.grad's carried
    over by state_dict_from_jax. Returns the JAX outputs."""
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        out = module.apply({"params": p}, **jin, deterministic=True)
        return jax_app.loss_fn(out, jbatch)["loss"], out

    (want_loss, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    tmodule.eval()
    got = tmodule(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    got_loss = port_app.loss_fn(got, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})["loss"]
    assert set(want) <= set(got) | {"hidden_states"}, (set(want), set(got))
    for key, w in want.items():
        g = got[key].detach().numpy()
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=ATOL)
    got_loss.backward()
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads), config)
    named = dict(tmodule.named_parameters())
    assert set(want_grads) == set(named)
    for key, w in want_grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), w.numpy(),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert max(float(w.abs().max()) for w in want_grads.values()) > 1e-3
    return want


def assert_trained_like_jax(jax_trainer, port_app, ckpt, init_dir,
                            atol=ATOL, **build_kw):
    """The module weights the port's CLI saved in ckpt against the JAX
    trainer's params carried over by the app's state_dict_from_jax (atol),
    and training moved them (the comparison is not vacuous)."""
    app = port_app.from_pretrained(ckpt, device="cpu", **build_kw)
    want = port_app.state_dict_from_jax(
        jax.tree.map(np.asarray, jax_trainer.app.params), app.config)
    got = app.module.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=atol,
                                   rtol=0, err_msg=key)
    start = port_app.from_pretrained(init_dir, device="cpu", **build_kw)
    moved = max(float((got[k] - v).abs().max())
                for k, v in start.module.state_dict().items())
    assert moved > 1e-4


def eval_args(batch_size=4):
    return SimpleNamespace(eval_batch_size=batch_size,
                           user_defined_parameters_dict={})


def stub_forward(evaluator, outputs, to_torch):
    """Make `evaluator.forward` hand back successive batches of the given
    {key: [N, ...] array} outputs (as torch tensors for the port)."""
    state = {"start": 0}

    def forward(app, batch):
        n = len(batch["input_ids"])
        s = state["start"]
        state["start"] += n
        return {k: torch.from_numpy(v[s:s + n]) if to_torch else v[s:s + n]
                for k, v in outputs.items()}
    evaluator.forward = forward


def fresh_args():
    from easynlp_tpu.utils import global_vars
    global_vars._GLOBAL_ARGS = None


def run_port(argv):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    fresh_args()
    return default_main_fn(initialize_easynlp(args_list=argv
                                              + ["--device=cpu"]))


def run_jax(argv):
    from easynlp_tpu.appzoo.api import default_main_fn
    from easynlp_tpu.utils.initializer import initialize_easynlp
    fresh_args()
    return default_main_fn(initialize_easynlp(args_list=argv))


def read_tsv(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t") for line in f]


def assert_same_tsv(got_path, want_path, numeric=()):
    """The same rows and columns; the columns in `numeric` hold
    space-separated numbers, equal within ATOL, the others equal."""
    got, want = read_tsv(got_path), read_tsv(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in numeric:
                np.testing.assert_allclose(
                    np.array(a.split(), float), np.array(b.split(), float),
                    atol=ATOL, rtol=0)
            else:
                assert a == b, (i, a, b)
    return got


def assert_cli_imports_no_jax(argv):
    """The port's CLI on argv in a fresh interpreter: it exits 0 and no
    jax, flax or easynlp_tpu module is loaded."""
    code = (
        "import sys\n"
        "from easynlp_tpu_torch.cli import main\n"
        "assert main(%r) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'easynlp_tpu')"
        " or m.startswith('easynlp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n" % (argv + ["--device=cpu"],))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


@pytest.fixture(autouse=True)
def _restore_global_args():
    from easynlp_tpu.utils import global_vars
    saved = global_vars._GLOBAL_ARGS
    yield
    global_vars._GLOBAL_ARGS = saved


# --------------------------------------------------------------------------
# text_match
# --------------------------------------------------------------------------

SCHEMA = "id:str:1,a:str:1,b:str:1,label:str:1"


def make_pairs(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            a = " ".join(rng.choice(WORDS, rng.randint(2, 9)))
            b = " ".join(rng.choice(WORDS, rng.randint(1, 7)))
            f.write("%d\t%s\t%s\t%s\n" % (i, a, b,
                                          rng.choice(["match", "other"])))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_text_match"))
    make_bert_dir(os.path.join(base, "model"), heads={"classifier": 2})
    make_pairs(os.path.join(base, "train.tsv"), 32, seed=1)
    make_pairs(os.path.join(base, "dev.tsv"), 10, seed=2)
    return base


VARIANTS = {"cross": [], "two_tower": ["two_tower=True"],
            "siamese": ["siamese=True"]}


def common_argv(variant):
    udp = VARIANTS[variant]
    return (["--app_name=text_match", "--input_schema=" + SCHEMA,
             "--first_sequence=a", "--second_sequence=b",
             "--label_name=label", "--sequence_length=16",
             "--micro_batch_size=8", "--dtype=float32"]
            + (["--user_defined_parameters=" + " ".join(udp)] if udp else []))


@pytest.mark.parametrize("two_tower", [False, True],
                         ids=["cross", "two_tower"])
def test_dataset_features_match_jax(fixture_dir, two_tower):
    from easynlp_tpu.appzoo.text_match import data as J
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.text_match import data as P
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    name = "TwoTowerDataset" if two_tower else "TextMatchDataset"
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=12, input_schema=SCHEMA, first_sequence="a",
              second_sequence="b", label_name="label")
    path = os.path.join(fixture_dir, "train.tsv")
    want = getattr(J, name)(path, JaxTok.from_pretrained(model), **kw)
    got = getattr(P, name)(path, BertTokenizer.from_pretrained(model), **kw)
    assert got.label_mapping == want.label_mapping == {"match": 0, "other": 1}
    assert sorted(got.features) == sorted(want.features)
    assert ("input_ids_b" in got.features) == two_tower
    for k in want.features:
        np.testing.assert_array_equal(got.features[k], want.features[k],
                                      err_msg=k)


def _pair_inputs(seed, vocab, two_tower):
    rng = np.random.RandomState(seed)
    inputs = {}
    for side in ("", "_b") if two_tower else ("",):
        ids = rng.randint(5, vocab, (6, 12)).astype(np.int32)
        mask = np.ones((6, 12), np.int32)
        mask[np.arange(6), rng.randint(3, 13, 6) - 1] = 0
        mask = np.minimum.accumulate(mask, axis=1)
        types = np.zeros((6, 12), np.int32)
        types[:, 7:] = 1
        inputs.update({"input_ids" + side: ids, "attention_mask" + side: mask,
                       "token_type_ids" + side: types})
    return inputs


@pytest.mark.parametrize("pooling", ["cls", "avg"])
def test_two_tower_module_loss_and_grads_match_jax(fixture_dir, pooling):
    """TwoTowerModule (cls or masked-mean pooling): embeddings, similarity,
    the in-batch similarity matrix, logits, predictions, probabilities, the
    hinge loss and its gradients; and circle loss on the same outputs."""
    from easynlp_tpu.appzoo.text_match.model import (
        TextMatchTwoTower as JaxApp, TextMatchTwoTowerCircleLoss as JaxCircle)
    from easynlp_tpu_torch.appzoo.text_match.model import (
        TextMatchTwoTower, TextMatchTwoTowerCircleLoss, state_dict_from_jax)
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    args = SimpleNamespace(user_defined_parameters_dict={
        "two_tower_pooling": pooling}, remat="none")
    cfg, module, params = jax_params(JaxApp, config, seed=3, args=args)
    assert "pooler" not in params["backbone"]
    tmodule = port_module(TextMatchTwoTower, state_dict_from_jax(params, cfg),
                          config, args=args)
    assert tmodule.pooling == pooling
    inputs = _pair_inputs(4, config["vocab_size"], two_tower=True)
    want = check_parity(JaxApp, TextMatchTwoTower, module, params, tmodule,
                        inputs, {}, state_dict_from_jax, cfg)
    got = tmodule(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(
        TextMatchTwoTowerCircleLoss.loss_fn(got, {})["loss"].item(),
        float(JaxCircle.loss_fn(want, {})["loss"]), atol=ATOL)
    norms = np.linalg.norm(np.asarray(want["embeddings"]), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)


def test_cross_encoder_module_loss_and_grads_match_jax(fixture_dir):
    from easynlp_tpu.appzoo.text_match.model import TextMatch as JaxApp
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        state_dict_from_jax)
    from easynlp_tpu_torch.appzoo.text_match.model import TextMatch
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    cfg, module, params = jax_params(JaxApp, config, seed=5, num_labels=2)
    tmodule = port_module(TextMatch, state_dict_from_jax(params, cfg), config,
                          num_labels=2)
    inputs = _pair_inputs(6, config["vocab_size"], two_tower=False)
    batch = {"label_ids": np.array([0, 1, 1, 0, 1, 0], np.int32)}
    check_parity(JaxApp, TextMatch, module, params, tmodule, inputs, batch,
                 state_dict_from_jax, cfg)


@pytest.mark.parametrize("two_tower", [False, True],
                         ids=["cross", "two_tower"])
def test_evaluator_matches_jax(fixture_dir, two_tower):
    """Both evaluators on the dev set's 10 rows in batches of 4 (the last
    padded), fed the same logits: the same metrics, in the same order."""
    from easynlp_tpu.appzoo.text_match import data as JD
    from easynlp_tpu.appzoo.text_match import evaluator as JE
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.text_match import data as PD
    from easynlp_tpu_torch.appzoo.text_match import evaluator as PE
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    data = "TwoTowerDataset" if two_tower else "TextMatchDataset"
    name = ("TextMatchTwoTowerEvaluator" if two_tower
            else "TextMatchEvaluator")
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=12, input_schema=SCHEMA, first_sequence="a",
              second_sequence="b", label_name="label")
    path = os.path.join(fixture_dir, "dev.tsv")
    rng = np.random.RandomState(7)
    sim = np.tanh(rng.standard_normal(12)).astype(np.float32)
    logits = {"logits": np.stack([-sim, sim], -1)}
    results = []
    for mod_d, mod_e, tok, torch_out in (
            (JD, JE, JaxTok, False), (PD, PE, BertTokenizer, True)):
        dataset = getattr(mod_d, data)(path, tok.from_pretrained(model), **kw)
        evaluator = getattr(mod_e, name)(dataset, args=eval_args())
        stub_forward(evaluator, logits, torch_out)
        results.append(evaluator.evaluate(app=None))
    want, got = results
    assert [m for m, _ in got] == [m for m, _ in want]
    assert [m for m, _ in want][:2] == ["accuracy", "f1"]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-12)


@pytest.fixture(scope="module")
def trained(fixture_dir):
    """The port's CLI trains each variant for 4 steps on the tiny
    directory; {variant: checkpoint dir}."""
    out = {}
    for variant in VARIANTS:
        ckpt = os.path.join(fixture_dir, "ckpt_" + variant)
        trainer = run_port(["--mode=train",
                            "--tables=%s/train.tsv,%s/dev.tsv"
                            % (fixture_dir, fixture_dir),
                            "--pretrained_model_name_or_path=%s/model"
                            % fixture_dir, "--checkpoint_dir=" + ckpt,
                            "--epoch_num=1", "--learning_rate=1e-3",
                            "--logging_steps=1"] + common_argv(variant))
        assert trainer.global_step == 4 and trainer.nonfinite_skips == 0
        with open(os.path.join(ckpt, "label_mapping.json")) as f:
            assert json.load(f) == {"match": 0, "other": 1}
        out[variant] = ckpt
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cli_evaluate_and_predict_match_jax(fixture_dir, trained, variant):
    """Both CLIs evaluate and predict from the port's trained checkpoint
    (HF names: bert.*, and classifier.* for the cross-encoder): the same
    metrics and the same output TSV. Two-tower: predictions (similarity >
    0.5), similarity ("%.6f") and both embeddings; cross-encoder:
    classification's columns."""
    ckpt = trained[variant]
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % fixture_dir,
            "--checkpoint_dir=" + ckpt] + common_argv(variant)
    want, got = run_jax(argv), run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-9)
    if variant == "cross":
        schema, numeric = "predictions,probabilities,logits", (1, 2)
    else:
        schema, numeric = ("predictions,similarity,embeddings,embeddings_b",
                           (1, 2, 3))
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "pred_%s_%s.tsv"
                                 % (variant, tag))
        run(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
             "--outputs=" + outs[tag], "--checkpoint_dir=" + ckpt,
             "--output_schema=" + schema, "--append_cols=id"]
            + common_argv(variant))
    rows = assert_same_tsv(outs["port"], outs["jax"], numeric)
    assert [r[-1] for r in rows] == [str(i) for i in range(10)]
    if variant != "cross":
        for r in rows:
            assert r[0] == str(int(float(r[1]) > 0.5))


def test_cli_imports_no_jax(fixture_dir, trained):
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
        "--outputs=%s/pred_nojax.tsv" % fixture_dir,
        "--checkpoint_dir=" + trained["two_tower"],
        "--output_schema=predictions,similarity"] + common_argv("two_tower"))
    assert len(read_tsv("%s/pred_nojax.tsv" % fixture_dir)) == 10
