"""The port's ViT captioning (slice 12: image2text_generation's default and
enable_vit variant, video2text_generation) against the JAX package's, on
the CPU.

A tiny captioner (tests/test_torch_clip.py's ViT, a 2-layer GPT-2 of width
32 with 4 heads, a 130-token vocabulary) is initialised by the JAX package
and carried into the port through its state_dict_from_jax. Held to JAX in
f32: the caption logits (1e-5), the loss (1e-5 relative) and every
gradient (1e-5); greedy and 4-beam captions and video captions token for
token; the datasets bit for bit; the predictor's and pipeline()'s rows
from a `flax_params.msgpack` the JAX package saved; LossEvaluator's
eval_loss, where JAX's weights the padded rows of a last partial batch
(reference fault 27). The CLI test runs image2text_generation (default
and enable_vit) and video2text_generation train, evaluate and predict in
one fresh interpreter of the port's, which must load no jax, flax or
easynlp_tpu module; enable_vqgan selects the ARTIST captioner.
"""

import base64
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.appzoo.image2text_generation import model as JM
from easynlp_tpu.appzoo.video2text_generation import model as JV
from easynlp_tpu_torch.appzoo.image2text_generation import model as PM
from easynlp_tpu_torch.appzoo.video2text_generation import model as PV
from test_torch_clip import (CLI_RUN, VISION_CFG, b64_png, jax_apply,
                             np_tree, video_cell)
from test_torch_text_match import REPO, _restore_global_args  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import make_pretrained  # noqa: E402

GPT_CFG = dict(vocab_size=130, n_positions=64, n_embd=32, n_layer=2,
               n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
ATOL = 1e-5
MAX_LEN = 9


def make_pair(jax_cls=JM.CLIPGPTImageTextGeneration,
              port_cls=PM.CLIPGPTImageTextGeneration, seed=5, vocab=130):
    gpt = dict(GPT_CFG, vocab_size=vocab)
    jcfg = JM.I2TConfig(vision_config=VISION_CFG, gpt_config=gpt)
    module = jax_cls.build_module(jcfg, dtype=jnp.float32)
    params = np_tree(jax.jit(lambda: jax_cls.init_params(  # one compile
        module, jcfg, seed=seed))())
    # GPT-2 and visual_proj scaled 3x: at the init's scale a random tied
    # head repeats the current token, whatever the image
    params["gpt"] = jax.tree_util.tree_map(lambda x: x * 3, params["gpt"])
    params["visual_proj"]["kernel"] = params["visual_proj"]["kernel"] * 3
    jax_app = jax_cls(module, params, jcfg)
    cfg = PM.I2TConfig(vision_config=VISION_CFG, gpt_config=gpt)
    model = port_cls.build_module(cfg)
    model.load_state_dict(port_cls.state_dict_from_jax(params, cfg),
                          strict=True)
    return jax_app, port_cls(model.eval(), cfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _batch(seed, b=3, s=7, frames=None):
    rng = np.random.RandomState(seed)
    shape = (b, 32, 32, 3) if frames is None else (b, frames, 32, 32, 3)
    mask = np.ones((b, s), np.int32)
    mask[0, 5:] = 0
    return {"pixel_values": rng.rand(*shape).astype(np.float32),
            "input_ids": rng.randint(1, 130, (b, s)).astype(np.int32),
            "attention_mask": mask}


def test_caption_logits_loss_and_gradients_match_jax(pair):
    """The caption positions' logits after the 17-token visual prefix,
    next-token CE over real tokens and every gradient, in f32."""
    jax_app, app = pair
    batch = _batch(0)

    def jax_loss(p):
        o = jax_app.module.apply({"params": p}, **{
            k: jnp.asarray(v) for k, v in batch.items()})
        return JM.CLIPGPTImageTextGeneration.loss_fn(o, batch)["loss"], o
    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jax_app.params)
    out = app.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    assert out["prefix_len"] == want["prefix_len"] == 17
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = app.loss_fn(out, t)["loss"]
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want_grads = PM.CLIPGPTImageTextGeneration.state_dict_from_jax(
        np_tree(grads), app.config)
    for name, p in app.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=ATOL, rtol=1e-4, err_msg=name)
    app.module.zero_grad()


@pytest.mark.parametrize("beams", [1, 4])
def test_captions_match_jax_token_for_token(pair, beams):
    """generate() from [CLS] over the cached visual prefix, greedy and with
    4 beams (each image's pixels repeated per beam): JAX's ids exactly."""
    jax_app, app = pair
    pixels = _batch(1, b=4)["pixel_values"]
    want = np.asarray(jax_app.generate(pixels, max_length=MAX_LEN,
                                       num_beams=beams))
    got = app.generate(pixels, max_length=MAX_LEN, num_beams=beams).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:].ravel().tolist())) > 1


def test_sampled_captions_follow_the_generator(pair):
    """do_sample with top_k draws from the given torch.Generator (JAX's
    stream differs, ROADMAP reference fault 4): the same seed gives the
    same ids, and every id is in the vocabulary."""
    _, app = pair
    pixels = _batch(3, b=2)["pixel_values"]
    runs = [app.generate(pixels, max_length=MAX_LEN, do_sample=True,
                         top_k=5, generator=torch.Generator()
                         .manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, MAX_LEN)
    assert int(runs[0].max()) < GPT_CFG["vocab_size"]


def test_video_captions_and_loss_match_jax():
    """video2text: one CLS a frame as the prefix [B, F, E]; the loss and
    greedy captions of 3-frame videos equal JAX's."""
    jax_app, app = make_pair(JV.CLIPGPTFrameTextGeneration,
                             PV.CLIPGPTFrameTextGeneration)
    batch = _batch(2, frames=3)
    want = jax_apply(jax_app.module, jax_app.params, batch)
    with torch.no_grad():
        out = app.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    assert out["prefix_len"] == want["prefix_len"] == 3
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)
    want_ids = np.asarray(jax_app.generate(batch["pixel_values"],
                                           max_length=MAX_LEN))
    np.testing.assert_array_equal(
        app.generate(batch["pixel_values"], max_length=MAX_LEN).numpy(),
        want_ids)


# -- data, evaluator, predictor, pipeline -------------------------------------

def urlsafe_png(seed):
    return base64.urlsafe_b64encode(base64.b64decode(b64_png(seed))).decode()


@pytest.fixture(scope="module")
def caption_dir(tmp_path_factory):
    """(model dir: the fixtures' vocab, an I2TConfig and the JAX app's
    params as flax_params.msgpack; rows.tsv of 10 images and captions;
    frames.tsv of 6 frame lists and captions)."""
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    base = str(tmp_path_factory.mktemp("torch_captioning"))
    model_dir = make_pretrained(os.path.join(base, "model"))
    with open(os.path.join(model_dir, "vocab.txt")) as f:
        vocab = sum(1 for _ in f)
    jax_app, _ = make_pair(vocab=vocab)
    jax_app.config.save_pretrained(model_dir)
    save_params(jax_app.params, model_dir)
    rows = os.path.join(base, "rows.tsv")
    with open(rows, "w") as f:
        for i in range(10):
            f.write("%s\ta good day %d\n" % (urlsafe_png(i), i))
    frames = os.path.join(base, "frames.tsv")
    with open(frames, "w") as f:
        for i in range(6):
            f.write("%s\tthe day %d\n" % (video_cell(i, 1 + i % 4), i))
    return model_dir, rows, frames, jax_app


DS_KW = dict(max_seq_length=8, input_schema="image:str:1,text:str:1",
             first_sequence="image", second_sequence="text",
             user_defined_parameters={"img_size": 32})


@pytest.mark.parametrize("kind", ["image", "video"])
def test_caption_datasets_match_jax(caption_dir, kind):
    """ImageTextDataset and FrameTextDataset (frame_num 3; black frames
    pad a shorter list) bit for bit."""
    from easynlp_tpu.appzoo.image2text_generation.data import (
        ImageTextDataset as JD)
    from easynlp_tpu.appzoo.video2text_generation.data import (
        FrameTextDataset as JF)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu_torch.appzoo.image2text_generation.data import (
        ImageTextDataset)
    from easynlp_tpu_torch.appzoo.video2text_generation.data import (
        FrameTextDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model_dir, rows, frames, _ = caption_dir
    jcls, pcls, path = ((JD, ImageTextDataset, rows) if kind == "image"
                        else (JF, FrameTextDataset, frames))
    want = jcls(path, JTok.from_pretrained(model_dir), **DS_KW)
    got = pcls(path, BertTokenizer.from_pretrained(model_dir), **DS_KW)
    assert len(got) == len(want)
    b_got = got.batch_fn([got[i] for i in range(len(got))])
    b_want = want.batch_fn([want[i] for i in range(len(want))])
    for k in b_want:
        assert b_got[k].dtype == b_want[k].dtype
        np.testing.assert_array_equal(b_got[k], b_want[k])


def test_caption_predictor_and_pipeline_match_jax(caption_dir):
    """From the JAX package's flax_params.msgpack: the predictor's greedy
    rows (4 beams: test_captions_match_jax_token_for_token) equal JAX's,
    text and ids, and pipeline("image2text_generation", model_path=...)
    gives the same rows."""
    from easynlp_tpu.appzoo.image2text_generation.predictor import (
        ImageTextGenerationPredictor as JP)
    from easynlp_tpu_torch.appzoo.image2text_generation.predictor import (
        ImageTextGenerationPredictor)
    from easynlp_tpu_torch.pipelines import pipeline
    model_dir, rows, _, jax_app = caption_dir
    app = PM.CLIPGPTImageTextGeneration.from_pretrained(model_dir,
                                                        device="cpu")
    with open(rows) as f:
        cells = [line.split("\t")[0] for line in f]
    kw = dict(first_sequence="image", sequence_length=MAX_LEN, batch_size=4,
              user_defined_parameters={"img_size": 32})
    want = JP(model_dir, jax_app, **kw).run({"image": list(cells)})
    got = ImageTextGenerationPredictor(model_dir, app, **kw).run(
        {"image": list(cells)})
    assert got["generated_ids"] == want["generated_ids"]
    assert got["gen_text"] == want["gen_text"] == got["predictions"]
    rows_ = pipeline("image2text_generation", model_path=model_dir,
                     dtype=torch.float32, sequence_length=MAX_LEN,
                     device="cpu", batch_size=4)(cells)
    assert [r["gen_text"] for r in rows_] == want["gen_text"]
    assert [r["generated_ids"] for r in rows_] == want["generated_ids"]


def test_loss_evaluator_reference_fault_27(caption_dir):
    """JAX's LossEvaluator (shared by image2text, video2text and
    text2image) takes the loss of each whole batch, so the rows that pad a
    last partial batch (copies of row 0) weigh in its mean; the port takes
    each batch's loss over its real rows. 8 rows in batches of 4 give both
    the same eval_loss (1e-5 relative); 10 rows (a last batch of 2 real
    rows and 2 pads) give the port the loss of the 10 rows' batches and
    JAX another."""
    from easynlp_tpu.appzoo.image2text_generation.data import (
        ImageTextDataset as JD)
    from easynlp_tpu.appzoo.image2text_generation.evaluator import (
        ImageTextGenerationEvaluator as JE)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu.testing import make_args
    from easynlp_tpu_torch.appzoo.image2text_generation.data import (
        ImageTextDataset)
    from easynlp_tpu_torch.appzoo.image2text_generation.evaluator import (
        ImageTextGenerationEvaluator)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    model_dir, rows, _, jax_app = caption_dir
    app = PM.CLIPGPTImageTextGeneration.from_pretrained(model_dir,
                                                        device="cpu")
    short = rows + ".8"
    with open(rows) as f, open(short, "w") as g:
        g.writelines(f.readlines()[:8])
    args = initialize_easynlp(args_list=["--device=cpu", "--mode=evaluate",
                                         "--eval_batch_size=4"])
    results = {}
    for path in (short, rows):
        jds = JD(path, JTok.from_pretrained(model_dir), **DS_KW)
        pds = ImageTextDataset(path, BertTokenizer.from_pretrained(
            model_dir), **DS_KW)
        want = JE(jds, args=make_args(eval_batch_size=4)).evaluate(jax_app)
        got = ImageTextGenerationEvaluator(pds, args=args).evaluate(app)
        results[path] = (got[0][1], want[0][1])
        # the port's: each batch's loss over its real rows, weighted by
        # their count
        batches = [(pds.batch_fn([pds[i] for i in range(s, min(s + 4,
                                                               len(pds)))]))
                   for s in range(0, len(pds), 4)]
        total = 0.0
        for b in batches:
            t = {k: torch.from_numpy(v) for k, v in b.items()}
            with torch.no_grad():
                total += float(app.loss_fn(app.forward(t), t)["loss"]) \
                    * len(b["input_ids"])
        assert got[0][1] == pytest.approx(-total / len(pds), rel=1e-5)
    got8, want8 = results[short]
    assert got8 == pytest.approx(want8, rel=1e-5)
    got10, want10 = results[rows]
    assert abs(got10 - want10) > 3e-5 * abs(want10)  # 3x the tolerance


def test_enable_vqgan_still_raises():
    """enable_vqgan, which raised until slice 14, selects the ARTIST
    captioner and its dataset (held to JAX in tests/test_torch_artist.py
    and tests/test_torch_text2image.py); enable_vit the ViT captioner."""
    from easynlp_tpu_torch.appzoo import api
    from easynlp_tpu_torch.appzoo.image2text_generation import vqgan_model
    udp = {"enable_vqgan": True}
    assert api._resolve(api.MODEL_REGISTRY, "image2text_generation",
                        udp) is vqgan_model.VQGANGPTImageTextGeneration
    assert api._resolve(api.DATASET_REGISTRY, "image2text_generation",
                        udp) is vqgan_model.VQGANImageTextDataset
    vit = api._resolve(api.MODEL_REGISTRY, "image2text_generation",
                       {"enable_vit": "true"})
    assert vit is PM.CLIPGPTImageTextGeneration


def write_port_dir(path, vocab_dir, frames=False):
    """The port's own captioner directory: the fixtures' vocab, an
    I2TConfig and its init (seed 0) as pytorch_model.bin."""
    import shutil
    os.makedirs(path)
    shutil.copy(os.path.join(vocab_dir, "vocab.txt"), path)
    with open(os.path.join(path, "vocab.txt")) as f:
        vocab = sum(1 for _ in f)
    cfg = PM.I2TConfig(vision_config=VISION_CFG,
                       gpt_config=dict(GPT_CFG, vocab_size=vocab))
    cfg.save_pretrained(path)
    cls = PV.CLIPGPTFrameTextModule if frames else PM.CLIPGPTImageTextModule
    model = cls(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))


@pytest.fixture(scope="module")
def caption_cli(tmp_path_factory, caption_dir):
    model_dir, rows, frames, _ = caption_dir
    base = str(tmp_path_factory.mktemp("torch_captioning_cli"))
    write_port_dir(os.path.join(base, "i2t"), model_dir)
    write_port_dir(os.path.join(base, "v2t"), model_dir, frames=True)
    common = ["--device=cpu", "--dtype=float32", "--micro_batch_size=4",
              "--sequence_length=%d" % MAX_LEN, "--first_sequence=image",
              "--second_sequence=text",
              "--input_schema=image:str:1,text:str:1"]
    runs = []
    for app, name, table, udp in (
            ("image2text_generation", "i2t", rows, "img_size=32"),
            ("image2text_generation", "vit", rows,
             "img_size=32 enable_vit=true"),
            ("video2text_generation", "v2t", frames,
             "img_size=32 frame_num=3")):
        ckpt = os.path.join(base, "ckpt_" + name)
        src = os.path.join(base, "v2t" if name == "v2t" else "i2t")
        a = common + ["--app_name=" + app,
                      "--user_defined_parameters=" + udp]
        runs += [
            (name + "_train", a + ["--mode=train",
                                   "--tables=%s,%s" % (table, table),
                                   "--pretrained_model_name_or_path=" + src,
                                   "--checkpoint_dir=" + ckpt,
                                   "--epoch_num=1", "--learning_rate=1e-3",
                                   "--logging_steps=1"]),
            (name + "_eval", a + ["--mode=evaluate", "--tables=" + table,
                                  "--checkpoint_dir=" + ckpt])]
        for beams in ((1, 4) if name == "i2t" else (1,)):
            runs.append((
                "%s_pred%d" % (name, beams),
                a[:-1] + ["--user_defined_parameters=%s num_beams=%d"
                          % (udp, beams), "--mode=predict",
                          "--tables=" + table, "--checkpoint_dir=" + ckpt,
                          "--outputs=%s/%s_%d.tsv" % (base, name, beams),
                          "--output_schema=gen_text,generated_ids",
                          "--append_cols=text"]))
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUN % (runs,)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    preds = {}
    for name in ("i2t_1", "i2t_4", "vit_1", "v2t_1"):
        with open(os.path.join(base, name + ".tsv")) as f:
            preds[name] = [ln.rstrip("\n").split("\t") for ln in f]
    return json.loads(line[len("RESULT "):]), preds


def test_caption_cli_trains_evaluates_and_predicts(caption_cli):
    """image2text_generation (default and enable_vit: the same model, the
    same captions) and video2text_generation train 2 steps, evaluate
    (-loss, finite) and predict (greedy; image2text also 4 beams) through
    the port's CLI in a fresh interpreter that loads no jax, flax or
    easynlp_tpu module."""
    result, preds = caption_cli
    assert result["bad"] == []
    runs = result["runs"]
    for name, n in (("i2t", 10), ("vit", 10), ("v2t", 6)):
        assert runs[name + "_train"] == n // 4
        metric, value = runs[name + "_eval"][0]
        assert metric == "eval_loss" and np.isfinite(value) and value < 0
    assert preds["vit_1"] == preds["i2t_1"]
    for name, rows_ in preds.items():
        assert len(rows_) == (6 if name == "v2t_1" else 10)
        for row in rows_:
            ids = row[1].split()
            assert len(ids) == MAX_LEN and ids[0] == "2"  # [CLS]
