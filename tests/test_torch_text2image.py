"""The port's text2image_generation (ARTIST) and image2text_generation's
enable_vqgan variant against the JAX package's, on the CPU.

One tiny ARTIST directory (the fixtures' WordPiece vocabulary as the text
side, a 32-code codebook, 8 x 8 pixels in 16 codes, a 1-layer GPT of width
16; dropout off) whose weights the JAX package initialised and saved as
`flax_params.msgpack`, and tables of 10 url-safe PNG rows. Held to JAX in
f32: both datasets bit for bit; the evaluator's eval_loss (1e-5 relative)
on the JAX checkpoint, in-process and through the port's CLI; the
predictor's greedy images (top_k=1) within one level of JAX's PNGs, at
8 x 8; the enable_vqgan predictor (the VQGAN branch this slice repairs:
[-1, 1] pixels at the VQGAN's size) pixel for pixel and caption for
caption. One fresh interpreter of the port runs the CLI: text2image
evaluate on the JAX checkpoint, train (2 steps), evaluate, predict (PNGs)
and `--mode=serve`, and enable_vqgan train and predict; it must load no
jax, flax or easynlp_tpu module. pipeline() on its checkpoints gives the
CLI's PNGs byte for byte and its captions id for id, and the server
pipeline()'s rows. Reference faults 36 (random_crop=false turns random
crops on in JAX) and 37 (JAX's VQGAN predictor defaults to 64 px where
the dataset trains at 256) each have a test.
"""

import base64
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_text_match import REPO, _restore_global_args  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import make_pretrained  # noqa: E402

SIZE, TEXT_LEN, BATCH = 8, 8, 4
ARTIST = dict(image_vocab_size=32, image_token_length=16, text_length=8,
              codebook_dim=8, vq_channels=8, vq_channel_mult=(1, 2),
              vq_num_res_blocks=1,
              gpt_config=dict(n_positions=64, n_embd=16, n_layer=1, n_head=2,
                              resid_pdrop=0.0, embd_pdrop=0.0,
                              attn_pdrop=0.0))


def urlsafe_png(seed, size=12):
    from PIL import Image
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (size, size + seed % 5, 3),
                                      np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


def png_pixels(b64):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))),
                      np.int16)


@pytest.fixture(scope="module")
def t2i(tmp_path_factory):
    """(model dir with the JAX app's flax_params.msgpack, t2i rows, i2t
    rows, the JAX text2image app, the JAX VQGAN captioner)."""
    import jax
    import jax.numpy as jnp

    from easynlp_tpu.appzoo.image2text_generation.vqgan_model import (
        VQGANGPTImageTextGeneration as JV)
    from easynlp_tpu.appzoo.text2image_generation.model import (
        TextImageGeneration as JT)
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    from easynlp_tpu.modelzoo.models.artist import ARTISTConfig
    from easynlp_tpu.testing import make_args
    from test_torch_clip import np_tree
    make_args()
    base = str(tmp_path_factory.mktemp("torch_text2image"))
    model_dir = make_pretrained(os.path.join(base, "model"))
    with open(os.path.join(model_dir, "vocab.txt")) as f:
        vocab = sum(1 for _ in f)
    cfg = ARTISTConfig(text_vocab_size=vocab, **ARTIST)
    cfg.save_pretrained(model_dir)
    module = JT.build_module(cfg, dtype=jnp.float32)
    params = np_tree(jax.jit(lambda: JT.init_params(module, cfg,
                                                    seed=4))())
    save_params(params, model_dir)
    rows, caps = (os.path.join(base, n) for n in ("t2i.tsv", "i2t.tsv"))
    words = ["good", "day", "bad", "price", "phone", "the", "model"]
    with open(rows, "w") as f, open(caps, "w") as g:
        for i in range(10):
            text = " ".join(words[(i + j) % 7] for j in range(2 + i % 4))
            f.write("%s\t%s\n" % (text, urlsafe_png(i)))
            g.write("%s\t%s\n" % (urlsafe_png(20 + i), text))
    jv = JV.build_module(cfg, dtype=jnp.float32)
    return (model_dir, rows, caps, JT(module, params, cfg),
            JV(jv, params, cfg))


def _datasets(model_dir, path, udp, jax_cls, port_cls, schema, first,
              second, is_training=False):
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    kw = dict(max_seq_length=TEXT_LEN, input_schema=schema,
              first_sequence=first, second_sequence=second)
    want = jax_cls(path, JTok.from_pretrained(model_dir), is_training=True,
                   user_defined_parameters=udp[0], **kw) if is_training \
        else jax_cls(path, JTok.from_pretrained(model_dir),
                     user_defined_parameters=udp[0], **kw)
    got = port_cls(path, BertTokenizer.from_pretrained(model_dir),
                   is_training=is_training, user_defined_parameters=udp[1],
                   **kw)
    return want, got


def _all(ds):
    return ds.batch_fn([ds[i] for i in range(len(ds))])


T2I_SCHEMA = ("text:str:1,image:str:1", "text", "image")
I2T_SCHEMA = ("image:str:1,text:str:1", "image", "text")


@pytest.mark.parametrize("app", ["text2image", "vqgan"])
def test_datasets_match_jax(t2i, app):
    """TextImageDataset and VQGANImageTextDataset: ids, masks and [-1, 1]
    pixels at udp size, bit for bit."""
    from easynlp_tpu.appzoo.image2text_generation.vqgan_model import (
        VQGANImageTextDataset as JD)
    from easynlp_tpu.appzoo.text2image_generation.data import (
        TextImageDataset as JT)
    from easynlp_tpu_torch.appzoo.image2text_generation.vqgan_model import (
        VQGANImageTextDataset)
    from easynlp_tpu_torch.appzoo.text2image_generation.data import (
        TextImageDataset)
    model_dir, rows, caps = t2i[:3]
    udp = {"size": SIZE}
    args = ((rows, (udp, udp), JT, TextImageDataset) + T2I_SCHEMA
            if app == "text2image"
            else (caps, (udp, udp), JD, VQGANImageTextDataset) + I2T_SCHEMA)
    want, got = _datasets(model_dir, *args)
    b_want, b_got = _all(want), _all(got)
    assert sorted(b_got) == sorted(b_want)
    for k in b_want:
        assert b_got[k].dtype == b_want[k].dtype, k
        np.testing.assert_array_equal(b_got[k], b_want[k], err_msg=k)
    assert b_got["pixel_values"].shape == (10, SIZE, SIZE, 3)
    pixels = b_got["pixel_values"]
    assert pixels.min() >= -1 and pixels.max() <= 1


def test_random_crop_reference_fault_36(t2i):
    """`random_crop=false` on the command line: the JAX registry of typed
    user_defined_parameters lacks random_crop, so the string "false"
    reaches TextImageDataset's bool() and turns random crops on; the port
    reads the flag, and its training rows are the centre crops JAX's
    evaluation rows get."""
    from easynlp_tpu.appzoo.text2image_generation.data import (
        TextImageDataset as JT)
    from easynlp_tpu.utils.global_vars import (
        parse_user_defined_parameters as jax_parse)
    from easynlp_tpu_torch.appzoo.text2image_generation.data import (
        TextImageDataset)
    from easynlp_tpu_torch.utils.global_vars import (
        parse_user_defined_parameters)
    model_dir, rows = t2i[:2]
    raw = "random_crop=false size=%d" % SIZE
    udp = (jax_parse(raw), parse_user_defined_parameters(raw))
    assert udp[0]["random_crop"] == "false" and udp[1]["random_crop"] is False
    want, got = _datasets(model_dir, rows, udp, JT, TextImageDataset,
                          *T2I_SCHEMA, is_training=True)
    assert want.random_crop is True and got.random_crop is False
    centre, _ = _datasets(model_dir, rows, udp, JT, TextImageDataset,
                          *T2I_SCHEMA)
    np.testing.assert_array_equal(_all(got)["pixel_values"],
                                  _all(centre)["pixel_values"])
    assert not np.array_equal(_all(want)["pixel_values"],
                              _all(centre)["pixel_values"])
    on = parse_user_defined_parameters("random_crop=true")
    assert TextImageDataset(rows, want.tokenizer, is_training=True,
                            user_defined_parameters=on,
                            input_schema=T2I_SCHEMA[0]).random_crop


def _jax_eval_loss(t2i, path):
    from easynlp_tpu.appzoo.text2image_generation.data import (
        TextImageDataset as JD)
    from easynlp_tpu.appzoo.text2image_generation.evaluator import (
        TextImageGenerationEvaluator as JE)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu.testing import make_args
    model_dir, _, _, jax_app = t2i[:4]
    ds = JD(path, JTok.from_pretrained(model_dir), max_seq_length=TEXT_LEN,
            input_schema=T2I_SCHEMA[0], first_sequence="text",
            second_sequence="image", user_defined_parameters={"size": SIZE})
    return JE(ds, args=make_args(eval_batch_size=BATCH)).evaluate(
        jax_app)[0][1]


@pytest.fixture(scope="module")
def rows8(t2i, tmp_path_factory):
    """The first 8 rows: two whole batches, so JAX's LossEvaluator weighs
    no padding row (reference fault 27) and both packages agree."""
    path = str(tmp_path_factory.mktemp("t2i8") / "t2i8.tsv")
    with open(t2i[1]) as f, open(path, "w") as g:
        g.writelines(f.readlines()[:8])
    return path


def test_evaluator_on_the_jax_checkpoint_matches_jax(t2i, rows8):
    """TextImageGenerationEvaluator (LossEvaluator: the LM loss over the
    codes + VQ losses) on the app read from the JAX package's
    flax_params.msgpack: JAX's eval_loss within 1e-5 relative."""
    from easynlp_tpu_torch.appzoo.text2image_generation.data import (
        TextImageDataset)
    from easynlp_tpu_torch.appzoo.text2image_generation.evaluator import (
        TextImageGenerationEvaluator)
    from easynlp_tpu_torch.appzoo.text2image_generation.model import (
        TextImageGeneration)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    model_dir = t2i[0]
    app = TextImageGeneration.from_pretrained(model_dir, device="cpu")
    ds = TextImageDataset(rows8, BertTokenizer.from_pretrained(model_dir),
                          max_seq_length=TEXT_LEN,
                          input_schema=T2I_SCHEMA[0], first_sequence="text",
                          second_sequence="image",
                          user_defined_parameters={"size": SIZE})
    args = initialize_easynlp(args_list=["--device=cpu", "--mode=evaluate",
                                         "--eval_batch_size=%d" % BATCH])
    got = TextImageGenerationEvaluator(ds, args=args).evaluate(app)
    want = _jax_eval_loss(t2i, rows8)
    assert got[0][0] == "eval_loss" and got[0][1] < 0
    assert got[0][1] == pytest.approx(want, rel=1e-5)


def test_greedy_predictor_matches_jax(t2i):
    """TextImageGenerationPredictor with top_k=1 (greedy) on the JAX
    checkpoint: 8 x 8 PNGs within one level of JAX's predictor's, two
    images a row joined by \\x02 (max_generated_num 2)."""
    from easynlp_tpu.appzoo.text2image_generation.predictor import (
        TextImageGenerationPredictor as JP)
    from easynlp_tpu_torch.appzoo.text2image_generation.model import (
        TextImageGeneration)
    from easynlp_tpu_torch.appzoo.text2image_generation.predictor import (
        TextImageGenerationPredictor)
    model_dir, rows, _, jax_app = t2i[:4]
    with open(rows) as f:
        texts = [line.split("\t")[0] for line in f][:BATCH]
    kw = dict(first_sequence="text", sequence_length=TEXT_LEN,
              batch_size=BATCH,
              user_defined_parameters={"top_k": 1, "max_generated_num": 2})
    want = JP(model_dir, jax_app, **kw).run({"text": list(texts)})
    app = TextImageGeneration.from_pretrained(model_dir, device="cpu")
    got = TextImageGenerationPredictor(model_dir, app, **kw).run(
        {"text": list(texts)})
    assert got["predictions"] == got["gen_imgbase64"]
    for g, w in zip(got["gen_imgbase64"], want["gen_imgbase64"]):
        assert len(g.split("\x02")) == 2
        for gi, wi in zip(g.split("\x02"), w.split("\x02")):
            a, b = png_pixels(gi), png_pixels(wi)
            assert a.shape == (SIZE, SIZE, 3)
            assert np.abs(a - b).max() <= 1


def test_vqgan_predictor_matches_jax(t2i):
    """The captioning predictor's VQGAN branch: with udp size the
    port's pixels are JAX's [-1, 1] crops bit for bit, and its greedy
    captions JAX's, ids and text (beams: test_torch_artist.py)."""
    from easynlp_tpu.appzoo.image2text_generation.predictor import (
        ImageTextGenerationPredictor as JP)
    from easynlp_tpu_torch.appzoo.image2text_generation.predictor import (
        ImageTextGenerationPredictor)
    from easynlp_tpu_torch.appzoo.image2text_generation.vqgan_model import (
        VQGANGPTImageTextGeneration)
    model_dir, _, caps, _, jax_vq = t2i
    with open(caps) as f:
        cells = [line.split("\t")[0] for line in f]
    app = VQGANGPTImageTextGeneration.from_pretrained(model_dir,
                                                      device="cpu")
    kw = dict(first_sequence="image", sequence_length=6, batch_size=BATCH,
              user_defined_parameters={"size": SIZE})
    jp = JP(model_dir, jax_vq, **kw)
    pp = ImageTextGenerationPredictor(model_dir, app, **kw)
    data = {"image": list(cells)}
    np.testing.assert_array_equal(pp.preprocess(data)["pixel_values"],
                                  jp.preprocess(data)["pixel_values"])
    want, got = jp.run(dict(data)), pp.run(dict(data))
    assert got["generated_ids"] == want["generated_ids"]
    assert got["gen_text"] == want["gen_text"]
    assert len(got["generated_ids"][0].split()) == 7


def test_vqgan_predictor_size_reference_fault_37(t2i):
    """Without udp size: JAX's predictor takes 2 ** (levels - 1) * 4
    pixels (8 here; 64 at f16/16384 widths, 16 codes), a size
    VQGANImageTextDataset never trains at; the port's takes the dataset's
    default, 256."""
    from easynlp_tpu.appzoo.image2text_generation.predictor import (
        ImageTextGenerationPredictor as JP)
    from easynlp_tpu_torch.appzoo.image2text_generation.predictor import (
        ImageTextGenerationPredictor)
    from easynlp_tpu_torch.appzoo.image2text_generation.vqgan_model import (
        VQGANGPTImageTextGeneration, VQGANImageTextDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model_dir, _, caps, _, jax_vq = t2i
    app = VQGANGPTImageTextGeneration.from_pretrained(model_dir,
                                                      device="cpu")
    assert JP(model_dir, jax_vq).image_size == 2 ** 1 * 4
    port = ImageTextGenerationPredictor(model_dir, app)
    ds = VQGANImageTextDataset(caps, BertTokenizer.from_pretrained(
        model_dir), input_schema=I2T_SCHEMA[0], first_sequence="image",
        second_sequence="text")
    assert port.image_size == ds.vq_size == 256


CLI_CODE = """
import json, sys, urllib.request
from easynlp_tpu_torch.appzoo.api import default_main_fn
from easynlp_tpu_torch.utils.initializer import initialize_easynlp
out = {}
for name, argv in %r:
    result = default_main_fn(initialize_easynlp(args_list=argv))
    if name == "serve":
        req = urllib.request.Request(
            "http://127.0.0.1:%%d/predict" %% result.port,
            data=json.dumps({"inputs": %r}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out[name] = json.loads(r.read())["outputs"]
        result.stop()
    else:
        out[name] = (result.global_step if hasattr(result, "global_step")
                     else result if isinstance(result, list) else None)
bad = [m for m in sys.modules if m in ("jax", "flax", "easynlp_tpu")
       or m.startswith("easynlp_tpu.")]
print("RESULT " + json.dumps({"runs": out, "bad": bad}))
"""


@pytest.fixture(scope="module")
def cli(t2i, rows8, tmp_path_factory):
    """The port's CLI in one fresh interpreter: text2image evaluate on the
    JAX checkpoint; train from it (1 epoch of 8 rows, 2 steps), evaluate,
    predict (top-k 100, seed 3) and --mode=serve on the trained
    checkpoint; enable_vqgan train (2 steps) and greedy predict."""
    model_dir, rows, caps = t2i[:3]
    base = str(tmp_path_factory.mktemp("torch_t2i_cli"))
    common = ["--device=cpu", "--dtype=float32",
              "--micro_batch_size=%d" % BATCH,
              "--sequence_length=%d" % TEXT_LEN]
    t2i_a = common + ["--app_name=text2image_generation",
                      "--input_schema=" + T2I_SCHEMA[0],
                      "--first_sequence=text", "--second_sequence=image"]
    vq_a = common + ["--app_name=image2text_generation",
                     "--input_schema=" + I2T_SCHEMA[0],
                     "--first_sequence=image", "--second_sequence=text"]
    ckpt, vq_ckpt = (os.path.join(base, n) for n in ("ckpt", "vq_ckpt"))
    udp = "--user_defined_parameters=size=%d" % SIZE
    vq_udp = udp + " enable_vqgan=true"
    train = ["--mode=train", "--epoch_num=1", "--learning_rate=1e-3",
             "--logging_steps=1"]
    runs = [
        ("eval_jax", t2i_a + [udp, "--mode=evaluate", "--tables=" + rows8,
                              "--checkpoint_dir=" + model_dir]),
        ("train", t2i_a + [udp] + train + [
            "--tables=%s,%s" % (rows8, rows8),
            "--pretrained_model_name_or_path=" + model_dir,
            "--checkpoint_dir=" + ckpt]),
        ("eval", t2i_a + [udp, "--mode=evaluate", "--tables=" + rows8,
                          "--checkpoint_dir=" + ckpt]),
        ("predict", t2i_a + [udp + " seed=3", "--mode=predict",
                             "--tables=" + rows, "--checkpoint_dir=" + ckpt,
                             "--outputs=%s/t2i.tsv" % base,
                             "--output_schema=gen_imgbase64",
                             "--append_cols=text"]),
        ("serve", t2i_a + ["--mode=serve", "--checkpoint_dir=" + ckpt,
                           "--user_defined_parameters=serve_blocking=False "
                           "serve_port=0"]),
        ("vq_train", vq_a + [vq_udp] + train + [
            "--tables=%s,%s" % (caps, caps),
            "--pretrained_model_name_or_path=" + model_dir,
            "--checkpoint_dir=" + vq_ckpt]),
        ("vq_predict", vq_a + [vq_udp, "--mode=predict", "--tables=" + caps,
                               "--checkpoint_dir=" + vq_ckpt,
                               "--outputs=%s/i2t.tsv" % base,
                               "--output_schema=gen_text,generated_ids",
                               "--append_cols=text"]),
    ]
    with open(rows) as f:
        prompts = [line.split("\t")[0] for line in f][:BATCH]
    proc = subprocess.run(
        [sys.executable, "-c", CLI_CODE % (runs, prompts)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    preds = {}
    for name in ("t2i", "i2t"):
        with open(os.path.join(base, name + ".tsv")) as f:
            preds[name] = [ln.rstrip("\n").split("\t") for ln in f]
    return (json.loads(line[len("RESULT "):]), preds, ckpt, vq_ckpt, prompts,
            caps)


def test_cli_runs_without_jax(t2i, rows8, cli):
    """Every run of the CLI fixture in one interpreter that loads no jax,
    flax or easynlp_tpu module: the JAX checkpoint's eval_loss equal to
    JAX's (1e-5 relative), 2 training steps, a finite eval_loss after
    them, a 8 x 8 PNG a prompt, and enable_vqgan's 2 steps and captions
    from [CLS]."""
    result, preds = cli[:2]
    assert result["bad"] == []
    runs = result["runs"]
    assert runs["eval_jax"][0][1] == pytest.approx(_jax_eval_loss(t2i, rows8),
                                                   rel=1e-5)
    assert runs["train"] == 2 and runs["vq_train"] == 2
    metric, value = runs["eval"][0]
    assert metric == "eval_loss" and np.isfinite(value)
    assert len(preds["t2i"]) == 10
    for b64, _ in preds["t2i"]:
        assert png_pixels(b64).shape == (SIZE, SIZE, 3)
    assert len(preds["i2t"]) == 10
    for _, ids, _ in preds["i2t"]:
        ids = ids.split()
        assert len(ids) == TEXT_LEN + 1 and ids[0] == "2"  # [CLS]


def test_pipeline_and_server_match_the_cli(cli):
    """pipeline("text2image_generation", model_path=...) on the trained
    checkpoint, seed 3: the CLI's PNGs byte for byte; --mode=serve's rows
    for the first batch equal a fresh pipeline()'s (seed 0, the server's);
    pipeline() on the enable_vqgan checkpoint (its train_config.json
    names the variant) gives the CLI's captions."""
    from easynlp_tpu_torch.pipelines import pipeline
    result, preds, ckpt, vq_ckpt, prompts = cli[:5]
    texts = [r[1] for r in preds["t2i"]]
    kw = dict(dtype=torch.float32, device="cpu", sequence_length=TEXT_LEN,
              batch_size=BATCH)
    pipe = pipeline("text2image_generation", model_path=ckpt, **kw)
    pipe.predictor.generator.manual_seed(3)
    rows = pipe(texts)
    assert [r["gen_imgbase64"] for r in rows] == [r[0] for r in preds["t2i"]]
    fresh = [r["gen_imgbase64"] for r in pipeline(ckpt, **kw)(prompts)]
    assert [r["gen_imgbase64"] for r in result["runs"]["serve"]] == fresh
    assert len(set(fresh)) > 1
    with open(os.path.join(vq_ckpt, "train_config.json")) as f:
        assert "enable_vqgan=true" in json.load(f)["user_defined_parameters"]
    with open(cli[5]) as f:
        cells = [line.split("\t")[0] for line in f]
    caps = pipeline(vq_ckpt, **kw)(cells)
    assert [r["generated_ids"] for r in caps] == [r[1] for r in preds["i2t"]]
