"""The slice end to end: `--mode=predict --app_name=text_classify` through the
JAX package's CLI and the PyTorch port's CLI on one tiny model directory
(tests/fixtures/make_fixtures.py config, weights made with numpy from a seed
and saved as pytorch_model.bin with a `classifier.*` head) and one 32-row
TSV. Both run in f32 on the CPU; the output TSVs must agree."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import make_pretrained, make_tsv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = "id:str:1,sent:str:1,label:str:1"
OUT_SCHEMA = "predictions,probabilities,logits"


def _truncated_normal(rng, shape, std):
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return (x * std).astype(np.float32)


def write_weights(model_dir, seed=0, classifier_std=0.2):
    """HF-named BERT weights (bert. prefix) + a 2-way classifier, from a
    numpy seed; the classifier is wider than the 0.02 init so the random
    model's labels have margins to compare."""
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    rng = np.random.RandomState(seed)
    e, i = c["hidden_size"], c["intermediate_size"]
    shapes = {
        "embeddings.word_embeddings.weight": (c["vocab_size"], e),
        "embeddings.position_embeddings.weight":
            (c["max_position_embeddings"], e),
        "embeddings.token_type_embeddings.weight": (c["type_vocab_size"], e),
        "pooler.dense.weight": (e, e),
    }
    for n in range(c["num_hidden_layers"]):
        base = "encoder.layer.%d." % n
        for name in ("query", "key", "value"):
            shapes[base + "attention.self.%s.weight" % name] = (e, e)
        shapes[base + "attention.output.dense.weight"] = (e, e)
        shapes[base + "intermediate.dense.weight"] = (i, e)
        shapes[base + "output.dense.weight"] = (e, i)
    state = {}
    for key, shape in shapes.items():
        state["bert." + key] = torch.from_numpy(
            _truncated_normal(rng, shape, c["initializer_range"]))
        if key.endswith("dense.weight") or ".self." in key:
            state["bert." + key[:-len("weight")] + "bias"] = torch.from_numpy(
                (0.02 * rng.standard_normal(shape[0])).astype(np.float32))
    for ln in ["embeddings.LayerNorm"] + [
            "encoder.layer.%d.%s.LayerNorm" % (n, part)
            for n in range(c["num_hidden_layers"])
            for part in ("attention.output", "output")]:
        state["bert.%s.weight" % ln] = torch.from_numpy(
            (1 + 0.1 * rng.standard_normal(e)).astype(np.float32))
        state["bert.%s.bias" % ln] = torch.from_numpy(
            (0.1 * rng.standard_normal(e)).astype(np.float32))
    state["classifier.weight"] = torch.from_numpy(
        _truncated_normal(rng, (2, e), classifier_std))
    state["classifier.bias"] = torch.zeros(2)
    torch.save(state, os.path.join(model_dir, "pytorch_model.bin"))
    with open(os.path.join(model_dir, "label_mapping.json"), "w") as f:
        json.dump({"neg": 0, "pos": 1}, f)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_slice"))
    model_dir = make_pretrained(os.path.join(base, "model"))
    write_weights(model_dir)
    make_tsv(os.path.join(base, "dev.tsv"), 32, seed=3)
    return base


def predict_argv(base, outputs, *extra):
    return ["--mode=predict", "--app_name=text_classify",
            "--tables=%s/dev.tsv" % base, "--outputs=" + outputs,
            "--input_schema=" + SCHEMA, "--first_sequence=sent",
            "--output_schema=" + OUT_SCHEMA, "--append_cols=label",
            "--checkpoint_dir=%s/model" % base, "--micro_batch_size=16",
            "--sequence_length=16", "--dtype=float32", *extra]


def read_predictions(path):
    labels, probs, logits, appended = [], [], [], []
    with open(path) as f:
        for line in f:
            label, p, lg, app = line.rstrip("\n").split("\t")
            labels.append(label)
            probs.append([float(x) for x in p.split()])
            logits.append([float(x) for x in lg.split()])
            appended.append(app)
    return labels, np.array(probs), np.array(logits), appended


def _fresh_args():
    from easynlp_tpu.utils import global_vars
    global_vars._GLOBAL_ARGS = None


@pytest.fixture(autouse=True)
def _restore_global_args():
    """The CLIs set the process-wide args; put back what was there so no
    later test in this process sees the port's args."""
    from easynlp_tpu.utils import global_vars
    saved = global_vars._GLOBAL_ARGS
    yield
    global_vars._GLOBAL_ARGS = saved


def test_port_predict_matches_jax(fixture_dir):
    from easynlp_tpu import cli as jax_cli
    from easynlp_tpu_torch import cli as torch_cli
    from easynlp_tpu_torch.ops import attention as A

    jax_out = os.path.join(fixture_dir, "pred_jax.tsv")
    torch_out = os.path.join(fixture_dir, "pred_torch.tsv")
    _fresh_args()
    assert jax_cli.main(predict_argv(fixture_dir, jax_out)) == 0
    _fresh_args()
    A.short_attention_fwd.launches = 0
    assert torch_cli.main(predict_argv(fixture_dir, torch_out,
                                       "--device=cpu")) == 0
    assert A.short_attention_fwd.launches == 0  # CPU: the plain twin

    j_labels, j_probs, j_logits, j_app = read_predictions(jax_out)
    t_labels, t_probs, t_logits, t_app = read_predictions(torch_out)
    assert len(t_labels) == len(j_labels) == 32
    assert t_app == j_app
    margin = np.abs(j_logits[:, 0] - j_logits[:, 1])
    assert (margin > 1e-4).sum() >= 24  # the comparison is not vacuous
    for row in np.nonzero(margin > 1e-4)[0]:
        assert t_labels[row] == j_labels[row], row
    np.testing.assert_allclose(t_probs, j_probs, atol=1e-5)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-5)
    np.testing.assert_allclose(t_probs.sum(axis=1), 1.0, atol=1e-5)


def test_port_cli_imports_no_jax(fixture_dir):
    out = os.path.join(fixture_dir, "pred_nojax.tsv")
    code = (
        "import sys\n"
        "from easynlp_tpu_torch.cli import main\n"
        "assert main(%r) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'easynlp_tpu')"
        " or m.startswith('easynlp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n" % (predict_argv(fixture_dir, out,
                                               "--device=cpu"),))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert len(read_predictions(out)[0]) == 32


def test_port_sources_import_nothing_of_the_jax_package():
    """Static scan of every module of easynlp_tpu_torch/ and chip_smoke.py:
    no import statement, and no module path handed to importlib as a
    string, names jax, flax, optax or easynlp_tpu (the port keeps its own
    copies of what it shares with the JAX package)."""
    import ast
    import glob
    import re
    module = re.compile(r"(jax|flax|optax|easynlp_tpu)(\.\w+)*")
    dotted = re.compile(r"(jax|flax|optax|easynlp_tpu)(\.\w+)+")
    files = sorted(glob.glob(os.path.join(REPO, "easynlp_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 40
    # slice 13's latent diffusion modules are among them
    for rel in ("appzoo/latent_diffusion/model.py",
                "appzoo/latent_diffusion/controlnet_app.py",
                "modelzoo/models/latent_diffusion/unet.py",
                "modelzoo/models/latent_diffusion/autoencoder.py",
                "modelzoo/models/latent_diffusion/conversion.py",
                "modelzoo/models/latent_diffusion/esrgan.py",
                # and slice 14's ARTIST, TextCNN and BLOOM
                "modelzoo/models/artist/modeling_artist.py",
                "modelzoo/models/artist/generation.py",
                "modelzoo/models/cnn/modeling_cnn.py",
                "modelzoo/models/bloom/modeling_bloom.py",
                "appzoo/text2image_generation/model.py",
                "appzoo/text2image_generation/data.py",
                "appzoo/text2image_generation/predictor.py",
                "appzoo/image2text_generation/vqgan_model.py"):
        assert os.path.join(REPO, "easynlp_tpu_torch", rel) in files
    found = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names, banned = [], module
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                names, banned = [node.value], dotted  # "flax" is a word
            found += ["%s:%d %s" % (os.path.relpath(path, REPO), node.lineno,
                                    n) for n in names if banned.fullmatch(n)]
    assert not found, found


def test_device_cuda_never_falls_back_to_cpu():
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    _fresh_args()
    argv = ["--mode=predict", "--device=cuda"]
    if torch.cuda.is_available():
        assert initialize_easynlp(args_list=argv).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            initialize_easynlp(args_list=argv)


@pytest.mark.parametrize("argv,match", [
    # --mode=export is ported (slice 16, tests/test_torch_a26.py): an
    # export format it does not write raises the JAX api's ValueError
    pytest.param(["--mode=export",
                  "--user_defined_parameters=export_format=onnx"],
                 "unknown export_format", id="argv0-ROADMAP"),
    # every app is ported (text2image_generation since slice 14:
    # tests/test_torch_text2image.py); vectorization has no evaluator, in
    # the port as in the JAX package
    (["--mode=evaluate", "--app_name=vectorization"], "no entry"),
    # the A12 and A13 switches are ported; language_modeling has no
    # predictor, in the port as in the JAX package
    (["--mode=predict", "--app_name=language_modeling",
      "--user_defined_parameters=enable_kangaroo=true"], "no entry"),
])
def test_unported_modes_and_apps_raise(fixture_dir, argv, match):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    _fresh_args()
    args = initialize_easynlp(args_list=argv + [
        "--device=cpu", "--checkpoint_dir=%s/model" % fixture_dir])
    error = ValueError if "export" in match else NotImplementedError
    with pytest.raises(error, match=match):
        default_main_fn(args)


def test_use_flash_attention_flag_sets_the_override():
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    try:
        for flag, want in (("false", False), ("true", True), ("auto", None)):
            _fresh_args()
            initialize_easynlp(args_list=["--device=cpu",
                                          "--use_flash_attention=" + flag])
            assert A._KERNEL_OVERRIDE is want
    finally:
        A.set_kernel_override(None)


def test_chip_smoke_inputs(tmp_path):
    """chip_smoke.py's generated vocab and TSV: bert-base-chinese's 21128
    tokens, 256 three-column rows, and sentences the port's tokenizer maps
    to known pieces (so the BERT-base run sees real, varied lengths)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    tokens, cjk = chip_smoke._vocab()
    assert len(tokens) == len(set(tokens)) == 21128
    assert tokens.index("[UNK]") == 100 and tokens.index("[CLS]") == 101
    (tmp_path / "vocab.txt").write_text("\n".join(tokens) + "\n",
                                        encoding="utf-8")
    tsv = str(tmp_path / "rows.tsv")
    chip_smoke.make_tsv(tsv, cjk, seed=1234)
    with open(tsv, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert len(rows) == chip_smoke.N_ROWS
    assert all(len(r) == 3 and r[2] in ("negative", "positive")
               for r in rows)
    enc = BertTokenizer.from_pretrained(str(tmp_path))(
        [r[1] for r in rows], max_length=chip_smoke.SEQ_LEN)
    real = enc["attention_mask"].sum(axis=1)
    assert real.min() < 64 and real.max() == chip_smoke.SEQ_LEN
    assert (enc["input_ids"] == 100).mean() < 0.01
