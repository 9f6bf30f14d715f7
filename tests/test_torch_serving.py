"""The port's pipeline() and PredictionServer (easynlp_tpu_torch/pipelines,
easynlp_tpu_torch/serving/server.py) against the JAX package's.

One tiny text_classify directory (tests/fixtures/make_fixtures.py's BERT
config, tests/test_torch_text_classify.py's seeded weights with a 2-way
classifier, and a train_config.json naming the app), read by both packages
in f32 on the CPU. Bounds: labels equal, logits within 1e-4 (both print
them with %.6f); the HTTP route gives each row what pipeline() gives it.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_serving import _get, _post
from tests.test_torch_text_classify import write_weights

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import make_pretrained, make_tsv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_ATOL = 1e-4
KW = dict(sequence_length=16, batch_size=8, first_sequence="sent")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(model dir, 32 sentences)."""
    base = str(tmp_path_factory.mktemp("torch_serving"))
    model_dir = make_pretrained(os.path.join(base, "model"))
    write_weights(model_dir)
    with open(os.path.join(model_dir, "train_config.json"), "w") as f:
        json.dump({"app_name": "text_classify"}, f)
    rows = make_tsv(os.path.join(base, "dev.tsv"), 32, seed=5)
    with open(rows) as f:
        texts = [line.split("\t")[1] for line in f]
    return model_dir, texts


@pytest.fixture(scope="module")
def jax_rows(ckpt):
    """The JAX package's pipeline() rows for the 32 sentences."""
    import jax.numpy as jnp

    from easynlp_tpu.pipelines import pipeline as jax_pipeline
    from easynlp_tpu.utils import global_vars
    saved = global_vars._GLOBAL_ARGS
    try:
        pipe = jax_pipeline(ckpt[0], dtype=jnp.float32, **KW)
        return pipe(ckpt[1])
    finally:
        global_vars._GLOBAL_ARGS = saved


@pytest.fixture(scope="module")
def port_pipe(ckpt):
    from easynlp_tpu_torch.pipelines import pipeline
    return pipeline(ckpt[0], dtype=torch.float32, device="cpu", **KW)


def _logits(rows):
    return np.array([[float(x) for x in r["logits"].split()] for r in rows])


def assert_rows_match(got, want):
    assert len(got) == len(want) and sorted(got[0]) == sorted(want[0])
    assert [r["predictions"] for r in got] == \
        [r["predictions"] for r in want]
    np.testing.assert_allclose(_logits(got), _logits(want),
                               atol=LOGITS_ATOL)


def test_pipeline_matches_jax(ckpt, port_pipe, jax_rows):
    """pipeline(model_dir) infers text_classify from train_config.json;
    its rows equal the JAX pipeline's, and one string gives one row."""
    got = port_pipe(ckpt[1])
    assert_rows_match(got, jax_rows)
    margins = np.abs(np.diff(_logits(jax_rows), axis=1))[:, 0]
    assert (margins > 2 * LOGITS_ATOL).sum() >= 24  # labels decide
    one = port_pipe(ckpt[1][3])
    assert isinstance(one, dict) and one == got[3]


def test_pipeline_by_task_name_and_params_dtype(ckpt, port_pipe):
    """pipeline(task, model_path=dir) names the task; params_dtype casts
    the projections, embeddings and (bf16 being the compute dtype) biases
    to bf16 and keeps LayerNorms in f32; a bias in bf16 changes no
    output. Under f32 compute the biases stay f32."""
    from easynlp_tpu_torch.pipelines import pipeline
    named = pipeline("text_classify", model_path=ckpt[0],
                     dtype=torch.float32, device="cpu", **KW)
    assert named(ckpt[1][:4]) == port_pipe(ckpt[1][:4])
    cast = pipeline(ckpt[0], dtype=torch.bfloat16, params_dtype="bfloat16",
                    device="cpu", **KW)
    dtypes = {name.split(".", 1)[1]: p.dtype for name, p
              in cast.app.module.named_parameters() if "." in name}
    assert dtypes["encoder.layer.0.attention.self.query.weight"] == \
        torch.bfloat16
    assert dtypes["embeddings.word_embeddings.weight"] == torch.bfloat16
    assert dtypes["embeddings.LayerNorm.weight"] == torch.float32
    assert dtypes["embeddings.LayerNorm.bias"] == torch.float32
    assert dtypes["encoder.layer.0.attention.output.LayerNorm.bias"] == \
        torch.float32
    assert dtypes["encoder.layer.0.attention.self.query.bias"] == \
        torch.bfloat16
    # the same outputs as with the biases left in f32 (each projection
    # casts its bias to bf16 on use)
    from easynlp_tpu_torch.modelzoo.quantization import CAST_SKIP
    f32_bias = pipeline(ckpt[0], dtype=torch.bfloat16, device="cpu", **KW)
    for name, p in f32_bias.app.module.backbone.named_parameters():
        if not any(s in name.lower() for s in CAST_SKIP):
            p.data = p.data.to(torch.bfloat16)
    assert cast(ckpt[1][:4]) == f32_bias(ckpt[1][:4])
    f32 = pipeline(ckpt[0], dtype=torch.float32, params_dtype="bfloat16",
                   device="cpu", **KW)
    assert next(p.dtype for name, p in f32.app.module.named_parameters()
                if name.endswith("query.bias")) == torch.float32


@pytest.mark.parametrize("call,error,match", [
    (lambda p: __import__("easynlp_tpu_torch.pipelines").pipelines.pipeline(
        "text_classify"), RuntimeError, "not an existing pre-defined model"),
    (lambda p: __import__("easynlp_tpu_torch.pipelines").pipelines.pipeline(
        "bert-base-sst-registered-name"), ValueError, "cannot infer task"),
    (lambda p: __import__("easynlp_tpu_torch.pipelines").pipelines.pipeline(
        p, quantize="int4", device="cpu"), ValueError,
     "quantize must be 'int8'"),
    (lambda p: __import__("easynlp_tpu_torch.pipelines").pipelines.pipeline(
        "artist-base-zh"), ValueError, "cannot infer task"),
    (lambda p: __import__("easynlp_tpu_torch.pipelines").pipelines.pipeline(
        "chinese-ldm-general"), ValueError, "needs model_path"),
], ids=["default-model", "registered-name", "int8", "multimodal",
        "diffusion"])
def test_unported_pipeline_routes_raise(ckpt, call, error, match,
                                        monkeypatch, tmp_path):
    """With an empty model registry (slice 16 ported it,
    utils/zoo_registry.py) a task's default model, a registered name and a
    diffusion task without model_path raise the JAX package's errors; a
    quantize other than "int8" raises ValueError, as in JAX (int8 itself,
    which raised until slice 11, is held to JAX below)."""
    monkeypatch.setenv("EASYNLP_CACHE_ROOT", str(tmp_path / "cache"))
    monkeypatch.delenv("EASYNLP_REMOTE_MODELZOO", raising=False)
    with pytest.raises(error, match=match):
        call(ckpt[0])


def test_data_augmentation_pipeline_matches_jax(tmp_path):
    """pipeline("data_augmentation", model_path=...) (ROADMAP C27, which
    raised until slice 12): the augmented rows of a tiny masked LM equal
    JAX's pipeline's, row for row, in f32 (the masks come from each
    predictor's RandomState(0), the refills from the MLM head's argmax)."""
    import jax.numpy as jnp

    from easynlp_tpu.pipelines import pipeline as jax_pipeline
    from easynlp_tpu.utils import global_vars
    from easynlp_tpu_torch.pipelines import pipeline
    from tests.test_torch_language_modeling import make_mlm_dir
    model_dir = str(tmp_path / "mlm")
    make_mlm_dir(model_dir)
    rows = make_tsv(str(tmp_path / "aug.tsv"), 12, seed=9)
    with open(rows) as f:
        texts = [line.split("\t")[1] for line in f]
    saved = global_vars._GLOBAL_ARGS
    try:
        want = jax_pipeline("data_augmentation", model_path=model_dir,
                            dtype=jnp.float32, **KW)(texts)
    finally:
        global_vars._GLOBAL_ARGS = saved
    got = pipeline("data_augmentation", model_path=model_dir,
                   dtype=torch.float32, device="cpu", **KW)(texts)
    assert len(got) == len(texts) and sorted(got[0]) == sorted(want[0])
    assert [r["augmented"] for r in got] == [r["augmented"] for r in want]
    assert [r["predictions"] for r in got] == \
        [r["predictions"] for r in want]


def test_int8_pipeline_matches_jax(ckpt):
    """pipeline(quantize="int8") in f32: some weights quantized (fewer
    bytes), and the same labels as JAX's int8 pipeline with logits within
    1e-4."""
    import jax.numpy as jnp

    from easynlp_tpu.pipelines import pipeline as jax_pipeline
    from easynlp_tpu.utils import global_vars
    from easynlp_tpu_torch.modelzoo.quantization import (dequantize_for,
                                                         quantization_report)
    from easynlp_tpu_torch.pipelines import pipeline
    saved = global_vars._GLOBAL_ARGS
    try:
        want = jax_pipeline(ckpt[0], dtype=jnp.float32, quantize="int8",
                            **KW)(ckpt[1])
    finally:
        global_vars._GLOBAL_ARGS = saved
    pipe = pipeline(ckpt[0], dtype=torch.float32, quantize="int8",
                    device="cpu", **KW)
    assert dequantize_for(pipe.app.module)
    qbytes, obytes, _ = quantization_report(pipe.app.module)
    assert qbytes < obytes
    assert_rows_match(pipe(ckpt[1]), want)


def _fire(port, batches):
    """POST each list of inputs from its own thread at once."""
    results = [None] * len(batches)

    def fire(i):
        results[i] = _post(port, {"inputs": batches[i]})
    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


def test_prediction_server_matches_pipeline_and_jax(ckpt, port_pipe,
                                                    jax_rows):
    """serve(model_dir): 32 rows in 8 concurrent requests, coalesced into
    fewer batches of at most 8; every row equals pipeline()'s and the JAX
    server's (labels, logits within 1e-4)."""
    import jax.numpy as jnp

    from easynlp_tpu.serving import serve as jax_serve
    from easynlp_tpu.utils import global_vars
    from easynlp_tpu_torch.serving import serve
    texts = ckpt[1]
    batches = [texts[i:i + 4] for i in range(0, 32, 4)]
    srv = serve(ckpt[0], port=0, max_batch_size=8, max_delay_ms=50,
                blocking=False, dtype=torch.float32, device="cpu", **KW)
    saved = global_vars._GLOBAL_ARGS
    jax_srv = jax_serve(ckpt[0], port=0, max_batch_size=8, max_delay_ms=50,
                        blocking=False, dtype=jnp.float32, **KW)
    global_vars._GLOBAL_ARGS = saved
    try:
        got = _fire(srv.port, batches)
        want = _fire(jax_srv.port, batches)
        status, info = _get(srv.port, "/info")
    finally:
        srv.stop()
        jax_srv.stop()
    assert all(s == 200 for s, _ in got + want), (got, want)
    rows = [r for _, body in got for r in body["outputs"]]
    assert rows == port_pipe(texts)
    assert_rows_match(rows, [r for _, b in want for r in b["outputs"]])
    assert_rows_match(rows, jax_rows)
    stats = info["stats"]
    assert stats["examples"] == 32 and stats["batches"] < 8
    assert info["max_batch_size"] == 8 and info["model"] == ckpt[0]


def test_batching_coalesces_and_errors_keep_serving():
    """A stand-in pipeline: 8 concurrent singleton requests run in fewer
    pipeline calls; single input, a failing batch (500), an empty request
    (400) and an unknown path (404), and the server still answers."""
    from easynlp_tpu_torch.serving import PredictionServer
    sizes = []

    def pipe(inputs):
        sizes.append(len(inputs))
        if "boom" in inputs:
            raise ValueError("bad input")
        return [{"echo": x.upper(), "arr": np.arange(2)} for x in inputs]
    srv = PredictionServer(pipe, port=0, max_batch_size=16,
                           max_delay_ms=150).start()
    try:
        results = _fire(srv.port, [["req-%d" % i] for i in range(8)])
        assert [b["outputs"] for _, b in results] == [
            [{"echo": "REQ-%d" % i, "arr": [0, 1]}] for i in range(8)]
        assert sum(sizes) == 8 and len(sizes) < 8
        status, body = _post(srv.port, {"input": "hello"})
        assert status == 200 and body["output"]["echo"] == "HELLO"
        status, body = _post(srv.port, {"input": "boom"})
        assert status == 500 and "bad input" in body["error"]
        assert _post(srv.port, {})[0] == 400
        assert _post(srv.port, {"inputs": ["x"]}, path="/nope")[0] == 404
        status, body = _post(srv.port, {"inputs": ["ok"]})
        assert status == 200 and body["outputs"][0]["echo"] == "OK"
        status, body = _get(srv.port, "/health")
        assert status == 200 and body["status"] == "ok"
    finally:
        srv.stop()


def test_cli_serve_default_route_imports_no_jax(ckpt, port_pipe):
    """`--mode=serve` without serve_continuous, in a fresh process: the
    pipeline server answers /predict with pipeline()'s rows, and no jax,
    flax or easynlp_tpu module is loaded. serve_quantize=int8 (which
    raised until slice 11) serves pipeline(quantize="int8")'s rows."""
    argv = ["--mode=serve", "--checkpoint_dir=" + ckpt[0],
            "--first_sequence=sent", "--sequence_length=16",
            "--micro_batch_size=8", "--dtype=float32", "--device=cpu",
            "--user_defined_parameters=serve_blocking=False serve_port=0"]
    code = (
        "import json, sys, urllib.request\n"
        "from easynlp_tpu_torch.appzoo.api import default_main_fn\n"
        "from easynlp_tpu_torch.utils.initializer import initialize_easynlp\n"
        "srv = default_main_fn(initialize_easynlp(args_list=%r))\n"
        "req = urllib.request.Request('http://127.0.0.1:%%d/predict' %% "
        "srv.port, data=json.dumps({'inputs': %r}).encode())\n"
        "with urllib.request.urlopen(req, timeout=60) as r:\n"
        "    print('ROWS ' + json.dumps(json.loads(r.read())['outputs']))\n"
        "srv.stop()\n"
        "srv = default_main_fn(initialize_easynlp(args_list=%r))\n"
        "req = urllib.request.Request('http://127.0.0.1:%%d/predict' %% "
        "srv.port, data=json.dumps({'inputs': %r}).encode())\n"
        "with urllib.request.urlopen(req, timeout=60) as r:\n"
        "    print('INT8 ' + json.dumps(json.loads(r.read())['outputs']))\n"
        "srv.stop()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'easynlp_tpu')"
        " or m.startswith('easynlp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n" % (
            argv, ckpt[1][:5],
            argv[:-1] + [argv[-1] + " serve_quantize=int8"], ckpt[1][:5]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "NO_JAX_OK"
    rows = [line[5:] for line in lines if line.startswith("ROWS ")]
    assert json.loads(rows[0]) == port_pipe(ckpt[1][:5])
    from easynlp_tpu_torch.pipelines import pipeline
    int8 = [line[5:] for line in lines if line.startswith("INT8 ")]
    assert json.loads(int8[0]) == pipeline(
        ckpt[0], dtype=torch.float32, quantize="int8", device="cpu",
        **KW)(ckpt[1][:5])
