"""The port's reader of the JAX package's `flax_params.msgpack`
(easynlp_tpu_torch/utils/flax_checkpoint.py) against flax's own
serialization, and `Application.from_pretrained` on a directory that holds
only that file:

- every leaf type flax writes (f32, bf16, integer and bool arrays, numpy
  and Python scalars, strings, None, complex) decodes to flax's values;
  an array that flax's chunking splits (its chunk size patched down)
  decodes exactly; a subprocess in which `import msgpack` and `import flax`
  fail reads a file and predicts through the port's CLI;
- every ported app that has a `state_dict_from_jax` loads a JAX app's
  params from the file (heads included) and its forward matches the JAX
  app's within 1e-5 in f32; the base class raises naming ROADMAP A6;
- where both files exist the port keeps reading pytorch_model.bin;
- text_classify trained by the JAX CLI predicts through the port's CLI
  with the same labels and logits within 1e-5.
"""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_text_match import (
    ATOL,
    _restore_global_args,  # noqa: F401
    make_bert_dir,
    read_tsv,
    run_jax,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import make_pretrained, make_tsv  # noqa: E402
from test_torch_text_classify import write_weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    rng = np.random.RandomState(0)
    return {
        "backbone": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                     "half": jnp.asarray(rng.standard_normal((4, 2)),
                                         jnp.bfloat16),
                     "ids": np.arange(-3, 9, dtype=np.int64).reshape(3, 4),
                     "small": np.array([-2, 7], np.int8),
                     "flags": np.array([True, False])},
        "scalars": {"f": np.float32(1.5), "i": np.int32(-7), "py_int": 300,
                    "neg": -40000, "big": 2 ** 40, "py_float": 0.25,
                    "text": "état", "none": None, "yes": True,
                    "z": complex(1.0, -2.0)},
        "empty": {},
        "long_key_" + "x" * 40: np.zeros((0, 3), np.float32),
    }


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], path + "/" + k)
        return
    if isinstance(want, (np.ndarray, jax.Array)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert type(got) is type(want) or isinstance(want, np.generic), path
    assert got == want, path


def test_reader_decodes_what_flax_writes():
    from easynlp_tpu_torch.utils.flax_checkpoint import msgpack_restore
    tree = _tree()
    data = serialization.to_bytes(tree)
    got = msgpack_restore(data)
    _assert_same(got, serialization.msgpack_restore(data))
    _assert_same(got, tree)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])


def test_reader_joins_chunked_arrays(monkeypatch):
    """flax splits an array above MAX_CHUNK_SIZE bytes into a map of flat
    chunks; with the size patched to 64 bytes a [7, 9] f32 array (252
    bytes) takes 4 chunks and a [2, 3] one none."""
    from easynlp_tpu_torch.utils.flax_checkpoint import msgpack_restore
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(63, dtype=np.float32).reshape(7, 9) / 7
    tree = {"layer": {"kernel": big, "bias": np.ones((2, 3), np.float32)}}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same(msgpack_restore(data), tree)


# --------------------------------------------------------------------------
# every app with a converter
# --------------------------------------------------------------------------

def _bert_case(app, heads, udp=None, n=2, outputs=("logits",)):
    return dict(app=app, udp=udp or {}, n=n, outputs=outputs,
                make=lambda d: make_bert_dir(d, heads=heads))


def _gpt2_dir(d):
    from test_torch_sequence_generation import make_model_dir
    make_model_dir(d)


def _bart_dir(d):
    from test_torch_seq2seq_train import make_bart_dir
    make_bart_dir(d)


def _mlm_dir(d):
    from test_torch_language_modeling import make_mlm_dir
    make_mlm_dir(d)


APPS = {
    "text_classify": _bert_case("text_classify", {"classifier": 3}, n=3),
    "text_classify-multi_label": _bert_case(
        "text_classify", {"classifier": 4}, {"multi_label": "true"}, n=4),
    "text_match": _bert_case("text_match", {"classifier": 2}),
    "text_match-two_tower": _bert_case(
        "text_match", None, {"two_tower": "True"}, outputs=("embeddings",)),
    "sequence_labeling": _bert_case("sequence_labeling", {"classifier": 5},
                                    n=5),
    "machine_reading_comprehension": _bert_case(
        "machine_reading_comprehension", {"qa_outputs": 2},
        outputs=("start_logits", "end_logits")),
    "vectorization": _bert_case("vectorization", None,
                                outputs=("embeddings",)),
    "information_extraction": _bert_case("information_extraction", None,
                                         n=3, outputs=("span_scores",)),
    "geep_classify": _bert_case("geep_classify", None,
                                outputs=("logits", "exit_logits")),
    "language_modeling": dict(app="language_modeling", udp={}, n=2,
                              outputs=("logits",), make=_mlm_dir),
    "sequence_generation-gpt2": dict(app="sequence_generation", udp={}, n=2,
                                     outputs=("logits",), make=_gpt2_dir),
    "sequence_generation-bart": dict(app="sequence_generation", udp={}, n=2,
                                     outputs=("logits",), make=_bart_dir),
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_app_loads_a_jax_checkpoint(tmp_path, name):
    """The JAX app's params (every leaf moved by noise, so heads it
    initialises itself count too) saved by the JAX package's save_params
    into a directory without pytorch_model.bin: the port's app loads them
    strictly and its forward gives the JAX app's outputs within 1e-5."""
    from easynlp_tpu.appzoo import api as jax_api
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    from easynlp_tpu_torch.appzoo import api
    case = APPS[name]
    src, dst = str(tmp_path / "hf"), str(tmp_path / "flax")
    case["make"](src)
    args = SimpleNamespace(user_defined_parameters_dict=case["udp"])
    jax_app = jax_api.get_application_model(case["app"], case["udp"]) \
        .from_pretrained(src, args=args, dtype=jnp.float32,
                         num_labels=case["n"])
    rng = np.random.RandomState(1)
    jax_app.params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape))
        .astype(np.float32), jax_app.params)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.bin"))
    save_params(jax_app.params, dst)
    port_app = api._resolve(api.MODEL_REGISTRY, case["app"], case["udp"]) \
        .from_pretrained(dst, args=args, device="cpu", num_labels=case["n"])
    vocab = port_app.config.vocab_size
    ids = np.random.RandomState(2).randint(4, vocab, (2, 8)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.array(
        [[1] * 8, [1] * 5 + [0] * 3], np.int32)}
    if name.endswith("bart"):
        batch["decoder_input_ids"] = ids[:, :5]
    want = jax_app.forward({k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port_app.forward({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    for key in case["outputs"]:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_base_application_names_a6():
    from easynlp_tpu_torch.appzoo.application import Application
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        Application.state_dict_from_jax({}, None)


def test_pytorch_checkpoint_is_preferred(tmp_path):
    """With both files in a directory the port reads pytorch_model.bin (a
    flax file it could not parse is then never opened)."""
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        normalize_keys)
    d = str(tmp_path / "both")
    make_bert_dir(d, heads={"classifier": 2})
    (tmp_path / "both" / "flax_params.msgpack").write_bytes(b"\xc1")
    app = SequenceClassification.from_pretrained(d, device="cpu")
    want = normalize_keys(torch.load(os.path.join(d, "pytorch_model.bin"),
                                     weights_only=True))
    assert torch.equal(app.module.classifier.weight,
                       want["classifier.weight"])


# --------------------------------------------------------------------------
# text_classify trained by the JAX CLI, predicted by the port's CLI
# --------------------------------------------------------------------------

SCHEMA = "id:str:1,sent:str:1,label:str:1"


def _predict_argv(base, ckpt, out):
    return ["--mode=predict", "--app_name=text_classify",
            "--tables=%s/dev.tsv" % base, "--outputs=" + out,
            "--input_schema=" + SCHEMA, "--first_sequence=sent",
            "--output_schema=predictions,probabilities,logits",
            "--append_cols=label", "--checkpoint_dir=" + ckpt,
            "--micro_batch_size=16", "--sequence_length=16",
            "--dtype=float32"]


def test_jax_trained_checkpoint_predicts_without_msgpack_or_flax(tmp_path):
    """The JAX CLI trains text_classify (4 steps) and writes
    flax_params.msgpack; the port's CLI predicts from it in a process where
    importing msgpack, flax or jax fails: the JAX CLI's labels, and its
    probabilities and logits within 1e-5."""
    base = str(tmp_path)
    write_weights(make_pretrained(os.path.join(base, "model")))
    make_tsv(os.path.join(base, "train.tsv"), 64, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 24, seed=2)
    ckpt = os.path.join(base, "jax_ckpt")
    run_jax(["--mode=train", "--app_name=text_classify",
             "--tables=%s/train.tsv" % base, "--input_schema=" + SCHEMA,
             "--first_sequence=sent", "--label_name=label",
             "--sequence_length=16", "--micro_batch_size=16",
             "--dtype=float32", "--epoch_num=1", "--learning_rate=1e-3",
             "--pretrained_model_name_or_path=%s/model" % base,
             "--checkpoint_dir=" + ckpt])
    assert sorted(f for f in os.listdir(ckpt) if "params" in f
                  or f.endswith(".bin")) == ["flax_params.msgpack"]
    want_out = os.path.join(base, "pred_jax.tsv")
    run_jax(_predict_argv(base, ckpt, want_out))
    got_out = os.path.join(base, "pred_port.tsv")
    code = (
        "import sys\n"
        "for name in ('msgpack', 'flax', 'jax'):\n"
        "    sys.modules[name] = None  # import fails\n"
        "from easynlp_tpu_torch.cli import main\n"
        "assert main(%r) == 0\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and (m "
        "in ('jax', 'flax', 'msgpack', 'easynlp_tpu') or m.startswith("
        "'easynlp_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('NO_FLAX_OK')\n" % (_predict_argv(base, ckpt, got_out)
                                   + ["--device=cpu"],))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_FLAX_OK" in proc.stdout
    got, want = read_tsv(got_out), read_tsv(want_out)
    assert len(got) == len(want) == 24
    with open(os.path.join(ckpt, "label_mapping.json")) as f:
        assert set(json.load(f)) == {"neg", "pos"}
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        for i in (1, 2):
            np.testing.assert_allclose(np.array(g[i].split(), float),
                                       np.array(w[i].split(), float),
                                       atol=ATOL, rtol=0)
