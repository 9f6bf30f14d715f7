"""vectorization (sentence embeddings, predict-only) in the PyTorch port
against the JAX package, at test_torch_text_match.py's tiny BERT, in f32 on
the CPU: identical features, the same L2-normalised embeddings ([CLS] or
masked-mean pooling) within 1e-5 and the same gradients of a function of
them, the same refusals (no loss, no evaluator), and the same output TSV
("%.8f" values within 1e-5) through both CLIs on a model directory of
HF-named numpy weights."""

import json
import os
from types import SimpleNamespace

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
    assert_same_tsv,
    jax_params,
    make_bert_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,text:str:1"


def make_rows(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write("%d\t%s\n" % (i, " ".join(rng.choice(
                WORDS, rng.randint(1, 20)))))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_vectorization"))
    make_bert_dir(os.path.join(base, "model"))
    make_rows(os.path.join(base, "rows.tsv"), 10, seed=1)
    return base


def common_argv(pooling=None):
    return (["--app_name=vectorization", "--input_schema=" + SCHEMA,
             "--first_sequence=text", "--sequence_length=16",
             "--micro_batch_size=4", "--dtype=float32"]
            + (["--user_defined_parameters=two_tower_pooling=" + pooling]
               if pooling else []))


def test_dataset_features_match_jax(fixture_dir):
    """The app's dataset is ClassificationDataset, as in the JAX
    registry."""
    from easynlp_tpu.appzoo.api import DATASET_REGISTRY as JAX_DATASETS
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.api import DATASET_REGISTRY
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=12, input_schema=SCHEMA, first_sequence="text")
    path = os.path.join(fixture_dir, "rows.tsv")
    want = JAX_DATASETS["vectorization"]["default"]()(
        path, JaxTok.from_pretrained(model), **kw).features
    cls = DATASET_REGISTRY["vectorization"]["default"]()
    assert cls.__name__ == "ClassificationDataset"
    got = cls(path, BertTokenizer.from_pretrained(model), **kw).features
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pooling", ["cls", "avg"])
def test_embeddings_and_grads_match_jax(fixture_dir, pooling):
    """The embeddings, and the gradients of sum(embeddings * w) for a
    seeded w, against JAX's module carried over by state_dict_from_jax;
    both apps refuse a loss."""
    from easynlp_tpu.appzoo.feature_vectorization.model import (
        FeatureVectorization as JaxApp)
    from easynlp_tpu_torch.appzoo.feature_vectorization.model import (
        FeatureVectorization)
    from easynlp_tpu_torch.appzoo.text_match.model import state_dict_from_jax
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    args = SimpleNamespace(user_defined_parameters_dict={
        "two_tower_pooling": pooling}, remat="none")
    cfg, module, params = jax_params(JaxApp, config, seed=6, args=args)
    tmodule = port_module(FeatureVectorization,
                          state_dict_from_jax(params, cfg), config, args=args)
    rng = np.random.RandomState(7)
    ids = rng.randint(5, config["vocab_size"], (5, 14)).astype(np.int32)
    mask = (np.arange(14)[None] < np.array([14, 3, 9, 1, 12])[:, None]
            ).astype(np.int32)
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": np.zeros_like(ids)}
    w = rng.standard_normal((5, config["hidden_size"])).astype(np.float32)

    def objective(p):
        out = module.apply({"params": p}, **{k: jnp.asarray(v) for k, v in
                                             inputs.items()},
                           deterministic=True)
        return jnp.sum(out["embeddings"] * w), out

    (want_obj, want), grads = jax.value_and_grad(objective, has_aux=True)(
        params)
    assert sorted(want) == ["embeddings"]
    got = tmodule(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert sorted(got) == ["embeddings"]
    np.testing.assert_allclose(got["embeddings"].detach().numpy(),
                               np.asarray(want["embeddings"]), atol=ATOL)
    obj = (got["embeddings"] * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(obj.item(), float(want_obj), atol=ATOL)
    obj.backward()
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, grads), cfg)
    named = dict(tmodule.named_parameters())
    assert set(want_grads) == set(named)
    for key, g in want_grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(),
                                   atol=ATOL, rtol=0, err_msg=key)
    for app in (JaxApp, FeatureVectorization):
        with pytest.raises(NotImplementedError, match="predict-only"):
            app.loss_fn(want, {})


def test_no_evaluator_in_either_package(fixture_dir):
    """vectorization has no evaluator in the JAX registry, so
    --mode=evaluate is refused on both sides."""
    argv = ["--mode=evaluate", "--tables=%s/rows.tsv" % fixture_dir,
            "--checkpoint_dir=%s/model" % fixture_dir] + common_argv()
    with pytest.raises(NotImplementedError, match="vectorization"):
        run_jax(argv)
    with pytest.raises(NotImplementedError, match="vectorization"):
        run_port(argv)


@pytest.mark.parametrize("pooling", [None, "avg"], ids=["cls", "avg"])
def test_cli_predict_matches_jax(fixture_dir, pooling):
    """10 rows in batches of 4: the same embeddings in `predictions` and
    `embeddings` ("%.8f" values), each of unit length."""
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "pred_%s_%s.tsv"
                                 % (pooling, tag))
        run(["--mode=predict", "--tables=%s/rows.tsv" % fixture_dir,
             "--outputs=" + outs[tag],
             "--checkpoint_dir=%s/model" % fixture_dir,
             "--output_schema=predictions,embeddings", "--append_cols=id"]
            + common_argv(pooling))
    rows = assert_same_tsv(outs["port"], outs["jax"], numeric=(0, 1))
    assert [r[2] for r in rows] == [str(i) for i in range(10)]
    for r in rows:
        emb = np.array(r[0].split(), float)
        assert len(emb) == 32 and abs(np.linalg.norm(emb) - 1) < 1e-6
        assert all(len(x.split(".")[1]) == 8 for x in r[0].split())


def test_cli_imports_no_jax(fixture_dir):
    out = "%s/pred_nojax.tsv" % fixture_dir
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/rows.tsv" % fixture_dir,
        "--outputs=" + out, "--checkpoint_dir=%s/model" % fixture_dir,
        "--output_schema=predictions"] + common_argv())
    assert len(read_tsv(out)) == 10
