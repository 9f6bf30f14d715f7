"""The port's latent diffusion apps (slice 13, A22) against the JAX
package's, on the CPU.

A small LDM (image 8, one UNet level of 8 channels with attention, one
head; a one-level VAE; a 1-layer BERT text tower of width 8 over the
fixtures' vocabulary) is initialised by the port and written under
CompVis's names; the JAX package reads that state dict through its own
`convert_stable_diffusion`, so every comparison also holds the names.
The port's modules are built with JAX's numerics where JAX departs from
CompVis (tests/test_torch_diffusion.py's `numerics`). f32 bounds below.

- The dataset (images to [-1, 1], the controlnet_hint_column) bit for bit.
- The CLI: latent_diffusion train, evaluate and predict (with do_upscale
  through the directory's ESRGAN), and enable_controlnet train, in one
  fresh interpreter of the port's that loads no jax, flax or easynlp_tpu
  module.
- A CompVis state dict (a `.ckpt` with its schedule buffers and EMA copy)
  through normalize_keys, and the CLI's trained checkpoint through JAX's
  convert_stable_diffusion: the same text context, noise prediction,
  latents and images; state_dict_from_jax inverts JAX's conversion.
- pipeline("chinese-ldm-general") and the predictor against JAX's on
  JAX's x_T: the same PNGs within one level.
- OLSS: the teacher path, the fit and the student against JAX's.
- ControlNet: residuals against JAX's, a fresh one a no-op, two training
  steps that leave the base bit for bit; edge_hint against JAX's.
- ESRGAN against JAX's RRDBNet, both names.
- FreePromptEditing (`edit`) and cross-frame `stylize_video` against JAX's.
- Reference faults 33 (a non-BERT text tower), 34 (do_upscale) and 35 (the
  predictor's unconditioned prompt).
"""

import base64
import io as _io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.appzoo.latent_diffusion import model as JM
from easynlp_tpu_torch.appzoo.latent_diffusion import model as PM
from easynlp_tpu_torch.modelzoo.models.latent_diffusion import (
    conversion,
    ddim as pddim,
)
from test_torch_clip import CLI_RUN
from test_torch_diffusion import nchw, nhwc, np_tree, numerics
from test_torch_text_match import REPO, _restore_global_args  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from make_fixtures import make_vocab  # noqa: E402

ATOL = 2e-5
SAMPLE_ATOL = 1e-4
TEXT_LEN = 8
ESRGAN = dict(nf=64, nb=1, gc=32)  # JAX's pipeline builds nf 64, gc 32


def small(vocab_size):
    return dict(
        image_size=8, model_channels=8, channel_mult=(1,), num_res_blocks=1,
        attention_levels=(0,), num_heads=1, context_dim=8, vae_channels=8,
        vae_channel_mult=(1,), vae_num_res_blocks=1,
        text_config=dict(vocab_size=vocab_size, hidden_size=8,
                         num_hidden_layers=1, num_attention_heads=1,
                         intermediate_size=16, max_position_embeddings=32,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0))


def _png(seed, size):
    from PIL import Image
    img = Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (size, size + seed % 3, 3), np.uint8))
    buf = _io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode_png(b64):
    from PIL import Image
    return np.asarray(Image.open(_io.BytesIO(base64.b64decode(b64))),
                      np.int16)


@pytest.fixture(scope="module")
def ldm(tmp_path_factory):
    """(model dir, its config kwargs, rows TSV, JAX params of its weights,
    the JAX ESRGAN params): vocab.txt, config.json, pytorch_model.bin (the
    port's init, CompVis names) and flax_params_esrgan.msgpack."""
    from flax import serialization
    from easynlp_tpu.modelzoo.models.latent_diffusion.conversion import (
        convert_stable_diffusion)
    from easynlp_tpu.modelzoo.models.latent_diffusion.esrgan import RRDBNet
    base = str(tmp_path_factory.mktemp("torch_ldm"))
    model_dir = os.path.join(base, "ldm")
    os.makedirs(model_dir)
    kw = small(make_vocab(os.path.join(model_dir, "vocab.txt")))
    cfg = PM.LDMConfig(**kw)
    cfg.save_pretrained(model_dir)
    module = PM.LDMModule(cfg)
    module.init_weights(torch.Generator().manual_seed(0))
    torch.save(module.state_dict(), os.path.join(model_dir,
                                                 "pytorch_model.bin"))
    esr = np_tree(jax.jit(lambda: RRDBNet(**ESRGAN).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"])())
    with open(os.path.join(model_dir, PM.ESRGAN_FLAX_NAME), "wb") as f:
        f.write(serialization.to_bytes(esr))
    rows = os.path.join(base, "rows.tsv")
    words = ["good", "bad", "price", "phone", "service"]
    with open(rows, "w") as f:
        for i in range(4):
            f.write("%s %s\t%s\t%s\n" % (words[i], words[i + 1],
                                         _png(i, 10 + i), _png(10 + i, 9)))
    params = np_tree(convert_stable_diffusion(
        {k: v.numpy() for k, v in module.state_dict().items()},
        JM.LDMConfig(**kw)))
    return model_dir, kw, rows, params, esr


def _jax_app(ldm):
    _, kw, _, params, _ = ldm
    config = JM.LDMConfig(**kw)
    return JM.LatentDiffusion(JM.LDMModule(config=config), params, config)


def _port_app(ldm, model_dir=None):
    """The port's app on the directory's weights with JAX's numerics."""
    model_dir = model_dir or ldm[0]
    with numerics():
        app = PM.LatentDiffusion.from_pretrained(model_dir, device="cpu")
    return app


def test_dataset_matches_jax(ldm):
    from easynlp_tpu.appzoo.latent_diffusion.data import LDMDataset as JD
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu_torch.appzoo.latent_diffusion.data import LDMDataset
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model_dir, _, rows, _, _ = ldm
    kw = dict(max_seq_length=TEXT_LEN,
              input_schema="text:str:1,image:str:1,hint:str:1",
              first_sequence="text", second_sequence="image", image_size=8,
              user_defined_parameters={"controlnet_hint_column": "hint"})
    got = LDMDataset(rows, BertTokenizer.from_pretrained(model_dir), **kw)
    want = JD(rows, JTok.from_pretrained(model_dir), **kw)
    assert len(got) == len(want) == 4
    for i in range(4):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for key in w:
            assert np.array_equal(np.asarray(g[key]), np.asarray(w[key])), key
        assert g["pixel_values"].shape == (8, 8, 3)
        assert 0.0 <= g["hint_values"].min() and g["hint_values"].max() <= 1


@pytest.fixture(scope="module")
def cli(ldm, tmp_path_factory):
    model_dir, _, rows, _, _ = ldm
    base = str(tmp_path_factory.mktemp("torch_ldm_cli"))
    ckpt = os.path.join(base, "ckpt")
    cn_ckpt = os.path.join(base, "ckpt_cn")
    pred = os.path.join(base, "pred.tsv")
    common = ["--app_name=latent_diffusion", "--device=cpu",
              "--dtype=float32", "--sequence_length=%d" % TEXT_LEN,
              "--micro_batch_size=2", "--first_sequence=text",
              "--second_sequence=image",
              "--input_schema=text:str:1,image:str:1,hint:str:1"]

    def train(out, udp):
        return ["--mode=train", "--tables=%s,%s" % (rows, rows),
                "--pretrained_model_name_or_path=" + model_dir,
                "--checkpoint_dir=" + out, "--epoch_num=1",
                "--learning_rate=1e-3", "--logging_steps=1",
                "--user_defined_parameters=image_size=8 " + udp] + common
    runs = [
        ("train", train(ckpt, "")),
        ("evaluate", ["--mode=evaluate", "--tables=" + rows,
                      "--checkpoint_dir=" + ckpt,
                      "--user_defined_parameters=image_size=8"] + common),
        ("predict", ["--mode=predict", "--tables=" + rows,
                     "--outputs=" + pred, "--checkpoint_dir=" + model_dir,
                     "--output_schema=gen_imgbase64", "--append_cols=text",
                     "--user_defined_parameters=num_steps=2 "
                     "guidance_scale=2 seed=3 n_samples=2 do_upscale=true"]
         + common),
        ("controlnet", train(cn_ckpt, "enable_controlnet=true "
                                      "controlnet_hint_column=hint")),
    ]
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUN % (runs,)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    with open(pred) as f:
        predictions = [ln.rstrip("\n").split("\t") for ln in f]
    return json.loads(line[len("RESULT "):]), ckpt, cn_ckpt, predictions


def test_cli_trains_evaluates_and_predicts(ldm, cli):
    """train (2 steps of 2 rows), evaluate, predict (2 images a prompt, 4x
    ESRGAN) and enable_controlnet train in one fresh interpreter that loads
    no jax, flax or easynlp_tpu module; the ControlNet checkpoint keeps the
    base bit for bit beside its pytorch_model_control.bin."""
    result, ckpt, cn_ckpt, predictions = cli
    assert result["bad"] == []
    runs = result["runs"]
    assert runs["train"] == 2 and runs["controlnet"] == 2
    assert runs["evaluate"][0][0] == "eval_loss"
    assert np.isfinite(runs["evaluate"][0][1]) and runs["evaluate"][0][1] < 0
    assert len(predictions) == 4
    for row in predictions:
        images = row[0].split(",")
        assert len(images) == 2
        for b64 in images:
            assert _decode_png(b64).shape == (32, 32, 3)  # 8 x 8, 4x
    base = torch.load(os.path.join(ldm[0], "pytorch_model.bin"))
    after = torch.load(os.path.join(cn_ckpt, "pytorch_model.bin"))
    assert sorted(base) == sorted(after)
    assert all(torch.equal(base[k], after[k]) for k in base)
    assert os.path.exists(os.path.join(cn_ckpt, "pytorch_model_control.bin"))
    trained = torch.load(os.path.join(ckpt, "pytorch_model.bin"))
    assert any(not torch.equal(base[k], trained[k]) for k in base)


def test_compvis_state_dict_through_jax_conversion(ldm, cli):
    """The CLI's trained checkpoint (CompVis names) read by JAX's
    convert_stable_diffusion and by the port: the text context, the noise
    prediction, the posterior mean and the decode agree; JAX's tree maps
    back onto the same state dict; a .ckpt dict with its schedule buffers,
    EMA copy and `bert.`-prefixed text tower loads through normalize_keys."""
    from easynlp_tpu.modelzoo.models.latent_diffusion.conversion import (
        convert_stable_diffusion)
    _, kw, _, _, _ = ldm
    ckpt = cli[1]
    state = torch.load(os.path.join(ckpt, "pytorch_model.bin"))
    config = JM.LDMConfig(**kw)
    params = np_tree(convert_stable_diffusion(
        {k: v.numpy() for k, v in state.items()}, config))
    back = conversion.state_dict_from_jax(params, PM.LDMConfig(**kw))
    assert sorted(back) == sorted(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    module = JM.LDMModule(config=config)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, kw["text_config"]["vocab_size"], (2, TEXT_LEN))
    pix = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 700], np.int32)

    def run(p):
        ctx = module.apply({"params": p}, ids, None,
                           method=module.encode_text)
        lat = module.apply({"params": p}, pix, method=module.encode_image)
        return (ctx, module.apply({"params": p}, x, t, ctx,
                                  method=module.predict_noise), lat,
                module.apply({"params": p}, x, method=module.decode_latents))
    want = jax.jit(run)(params)
    ckpt_dict = {"state_dict": dict(
        {k.replace("cond_stage_model.transformer.",
                   "cond_stage_model.transformer.bert."): v
         for k, v in state.items()},
        betas=torch.zeros(3), **{"model_ema.decay": torch.tensor(0.9),
                                 "first_stage_model.loss.w": torch.ones(1)})}
    with numerics():
        port = PM.LDMModule(PM.LDMConfig(**kw))
    PM.LatentDiffusion.load_state_dict(port, ckpt_dict)
    with torch.no_grad():
        ctx = port.encode_text(torch.from_numpy(ids))
        got = (ctx, port.predict_noise(nchw(x), torch.from_numpy(t).long(),
                                       ctx),
               port.encode_image(nchw(pix)),
               port.decode_latents(nchw(x)))
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(nhwc(g), w, atol=ATOL)


def _jax_pipeline(ldm, jax_app, num_steps):
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    pipe = JM.StableDiffusionPipeline.__new__(JM.StableDiffusionPipeline)
    pipe.app = jax_app
    pipe.tokenizer = JTok.from_pretrained(ldm[0])
    pipe.num_steps, pipe.guidance_scale = num_steps, 7.5
    pipe.image_prefix, pipe._esrgan = "", None
    return pipe


def _feed_x_t(monkeypatch, draws):
    """The port's sampler draws (x_T) replaced by the given NHWC arrays, in
    order."""
    queue = list(draws)

    def draw(shape, generator, device):
        x = nchw(queue.pop(0))
        assert tuple(x.shape) == tuple(shape)
        return x.to(device)
    monkeypatch.setattr(pddim, "draw_normal", draw)


def test_pipeline_and_predictor_match_jax(ldm, monkeypatch):
    """pipeline("chinese-ldm-general") and the predictor (a negative
    prompt given to both) on JAX's x_T: the same PNGs within one level of
    255 (f32 rounding at the uint8 cut). With do_upscale the port runs the
    directory's ESRGAN 4x where the JAX predictor returns the images as
    they were (reference fault 34)."""
    from easynlp_tpu.appzoo.latent_diffusion.predictor import (
        LDMPredictor as JP)
    from easynlp_tpu_torch.appzoo.latent_diffusion.predictor import (
        LDMPredictor)
    from easynlp_tpu_torch.pipelines import pipeline
    jax_app = _jax_app(ldm)
    prompts = ["good price", "bad phone"]
    want = _jax_pipeline(ldm, jax_app, 2)(prompts, seed=5,
                                          sequence_length=TEXT_LEN)
    shape = jax_app._latent_shape(2)
    _feed_x_t(monkeypatch, [jax.random.normal(jax.random.PRNGKey(5), shape)])
    with numerics():
        pipe = pipeline("chinese-ldm-general", model_path=ldm[0],
                        device="cpu", dtype=torch.float32,
                        sequence_length=TEXT_LEN)
    pipe._diffusion.num_steps = 2
    got = pipe(prompts)
    assert [r["text"] for r in got] == prompts
    for g, w in zip(got, want):
        d = np.abs(_decode_png(g["image_base64"])
                   - _decode_png(w["image_base64"]))
        assert d.max() <= 1
    udp = {"num_steps": "2", "seed": "7", "negative_prompt": "service",
           "do_upscale": "true"}
    data = {"text": prompts}
    jp = JP(ldm[0], jax_app, sequence_length=TEXT_LEN, batch_size=2,
            user_defined_parameters=udp)
    want = jp.postprocess(jp.predict(jp.preprocess(data)))["predictions"]
    _feed_x_t(monkeypatch, [jax.random.normal(jax.random.split(
        jax.random.PRNGKey(7))[1], shape)])
    app = _port_app(ldm)
    pp = LDMPredictor(ldm[0], app, sequence_length=TEXT_LEN, batch_size=2,
                      user_defined_parameters=dict(udp, do_upscale="false"))
    got = pp.postprocess(pp.predict(pp.preprocess(data)))["predictions"]
    for g, w in zip(got, want):
        assert np.abs(_decode_png(g) - _decode_png(w)).max() <= 1
    assert _decode_png(want[0]).shape == (8, 8, 3)   # JAX: no upscale
    up = LDMPredictor(ldm[0], app, sequence_length=TEXT_LEN, batch_size=2,
                      user_defined_parameters=udp)
    _feed_x_t(monkeypatch, [np.zeros(shape, np.float32)])
    assert _decode_png(up.postprocess(up.predict(up.preprocess(data)))[
        "predictions"][0]).shape == (32, 32, 3)


def test_predictor_unconditioned_prompt_reference_fault_35(ldm,
                                                           monkeypatch):
    """Without a negative prompt the JAX predictor conditions guidance's
    second branch on an all-PAD prompt (app.sample's default), while its
    own pipeline, and the reference predictor, tokenize "". The port's
    predictor tokenizes "": its images are the pipeline's, not those of the
    all-PAD branch."""
    from easynlp_tpu_torch.appzoo.latent_diffusion.predictor import (
        LDMPredictor)
    from easynlp_tpu_torch.pipelines import pipeline
    x_t = np.random.RandomState(9).standard_normal(
        (2, 8, 8, 4)).astype(np.float32)
    app = _port_app(ldm)
    prompts = ["good price", "bad phone"]
    pp = LDMPredictor(ldm[0], app, sequence_length=TEXT_LEN, batch_size=2,
                      user_defined_parameters={"num_steps": "2"})
    _feed_x_t(monkeypatch, [x_t] * 3)
    got = pp.postprocess(pp.predict(pp.preprocess({"text": prompts})))[
        "predictions"]
    with numerics():
        pipe = pipeline("latent_diffusion", model_path=ldm[0],
                        device="cpu", dtype=torch.float32,
                        sequence_length=TEXT_LEN)
    pipe._diffusion.num_steps = 2
    assert [r["image_base64"] for r in pipe(prompts)] == got
    enc = pp.tokenizer(prompts, max_length=TEXT_LEN)
    pad = app.sample(enc["input_ids"], enc["attention_mask"], num_steps=2,
                     x_init=nchw(x_t))
    assert np.abs(pad.numpy() - np.stack([
        _decode_png(g) / 127.5 - 1.0 for g in got])).max() > 1e-2


def test_olss_matches_jax():
    """OLSS on a closed-form denoiser: the DDIM teacher path, the fitted
    (timesteps, wx, we) from it and the student sampler against JAX's, and
    save/load."""
    from easynlp_tpu.modelzoo.models.latent_diffusion import olss as jolss
    from easynlp_tpu.modelzoo.models.latent_diffusion.ddim import (
        DiffusionSchedule)
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import olss
    from test_torch_diffusion import _closed_form_denoisers
    jfn, pfn = _closed_form_denoisers()
    x = np.random.RandomState(11).standard_normal((2, 4, 4, 4)).astype(
        np.float32)
    jt, jx, je = jolss.ddim_collect_path(jfn, x.shape, DiffusionSchedule(),
                                         num_steps=12, x_init=jnp.asarray(x))
    pt, px, pe = olss.ddim_collect_path(pfn, (2, 4, 4, 4),
                                        pddim.DiffusionSchedule(),
                                        num_steps=12, x_init=nchw(x))
    assert np.array_equal(pt, jt)
    np.testing.assert_allclose(px.transpose(0, 1, 3, 4, 2), jx, atol=1e-5)
    np.testing.assert_allclose(pe.transpose(0, 1, 3, 4, 2), je, atol=1e-5)
    want = jolss.fit_olss(jt, jx, je, 4)
    got = olss.fit_olss(jt, jx, je, 4)
    assert np.array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
    y_want = jax.jit(lambda x: jolss.olss_sample(jfn, x, *want))(x)
    y_got = olss.olss_sample(pfn, nchw(x), *got)
    np.testing.assert_allclose(nhwc(y_got), y_want, atol=1e-5)


def test_app_olss_fit_save_load_and_sample(ldm, tmp_path):
    """The app's fit_olss (a 6-step teacher, 3 student steps, guidance)
    and make_olss_sampler, through save_olss/load_olss: images in
    [-1, 1]."""
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import olss
    app = _port_app(ldm)
    ids = np.array([[2, 6, 7, 3, 0, 0, 0, 0]] * 2)
    fitted = app.fit_olss(ids, teacher_steps=6, student_steps=3,
                          guidance_scale=2.0,
                          generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "olss.npz")
    olss.save_olss(path, *fitted)
    loaded = olss.load_olss(path)
    assert [len(x) for x in loaded] == [3, 3, 3]
    images = app.make_olss_sampler(loaded, guidance_scale=2.0)(
        ids, None, None, torch.Generator().manual_seed(1))
    assert images.shape == (2, 8, 8, 3) and images.abs().max() <= 1


def test_controlnet_matches_jax_and_trains_with_the_base_frozen(ldm,
                                                                tmp_path):
    """ControlNetModel's residuals against JAX's on the same weights (the
    JAX tree through controlnet_state_dict_from_jax); edge_hint against
    JAX's; a fresh ControlNet (the UNet's copy, zero convs) samples the
    base model's images bit for bit; two Trainer steps move the ControlNet
    and leave the base bit for bit."""
    from easynlp_tpu.modelzoo.models.latent_diffusion import controlnet as jc
    from easynlp_tpu_torch.appzoo.latent_diffusion.controlnet_app import (
        ControlNetApplication)
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import (
        controlnet as pc)
    _, kw, _, _, _ = ldm
    config = JM.LDMConfig(**kw)
    rng = np.random.RandomState(12)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 8)).astype(np.float32)
    t = np.array([5, 900], np.int32)

    def run(x, img, t, ctx):
        hint = jc.edge_hint(img)
        net = jc.ControlNetModel(config=config)
        p = net.init(jax.random.PRNGKey(3), x, hint, t, ctx)["params"]
        p = jax.tree_util.tree_map(lambda a: a + 0.01, p)  # off zero
        return p, hint, net.apply({"params": p}, x, hint, t, ctx)
    params, hint, (downs, mid) = jax.jit(run)(x, img, t, ctx)
    np.testing.assert_array_equal(
        pc.edge_hint(torch.from_numpy(img)).numpy(), hint)
    with numerics():
        cnet = pc.ControlNetModel(PM.LDMConfig(**kw))
    cnet.load_state_dict(conversion.controlnet_state_dict_from_jax(
        np_tree(params), config), strict=True)
    with torch.no_grad():
        pd, pm = cnet(nchw(x), nchw(hint), torch.from_numpy(t).long(),
                      torch.from_numpy(ctx))
    assert len(pd) == len(downs)
    # the shifted weights give residuals of ~100: relative bound too
    for g, w in zip(list(pd) + [pm], list(downs) + [mid]):
        np.testing.assert_allclose(nhwc(g), w, atol=ATOL, rtol=1e-5)

    app = _port_app(ldm)
    ids = np.array([[2, 6, 7, 3, 0, 0, 0, 0]] * 2)
    x_t = nchw(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    control = ControlNetApplication(app, seed=4)
    base_images = app.sample(ids, num_steps=2, guidance_scale=2.0,
                             x_init=x_t)
    cn_images = control.sample(ids, None, None, (img + 1) / 2,
                               num_steps=2, guidance_scale=2.0, x_init=x_t)
    assert torch.equal(base_images, cn_images)
    from easynlp_tpu_torch.core.trainer import Trainer
    from test_torch_clip import _args
    args = _args(mode="train", micro_batch_size=2, epoch_num=1,
                 learning_rate=1e-2, logging_steps=1,
                 checkpoint_dir=str(tmp_path / "cn"))
    rows = [{"input_ids": ids[0].astype(np.int32),
             "attention_mask": (ids[0] > 0).astype(np.int32),
             "pixel_values": img[i]} for i in range(2)] * 2

    class Data(list):
        def batch_fn(self, examples):
            return {k: np.stack([e[k] for e in examples])
                    for k in examples[0]}
    base = {k: v.clone() for k, v in app.module.state_dict().items()}
    cn_before = {k: v.clone() for k, v in control.controlnet.state_dict()
                 .items()}
    Trainer(control, Data(rows), args=args).train()
    assert all(torch.equal(base[k], v)
               for k, v in app.module.state_dict().items())
    trained = control.controlnet.state_dict()
    assert any(not torch.equal(cn_before[k], v) for k, v in trained.items())
    # the checkpoint: the base as it was, the ControlNet beside it
    loaded = ControlNetApplication.load_control(
        _port_app(ldm, str(tmp_path / "cn")), str(tmp_path / "cn"))
    assert all(torch.equal(trained[k], v)
               for k, v in loaded.controlnet.state_dict().items())
    assert all(torch.equal(base[k], v)
               for k, v in loaded.inner.module.state_dict().items())


def test_esrgan_matches_jax(ldm):
    """RRDBNet on an 8 x 8 image against JAX's (the directory's
    flax_params_esrgan.msgpack through the port's msgpack reader), and the
    reference names through JAX's convert_rrdbnet."""
    from easynlp_tpu.modelzoo.models.latent_diffusion.esrgan import (
        RRDBNet, convert_rrdbnet)
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import esrgan
    model_dir, _, _, _, esr = ldm
    x = np.random.RandomState(13).uniform(0, 1, (1, 8, 8, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: RRDBNet(**ESRGAN).apply({"params": p}, x))(
        esr, x)
    net = PM.load_esrgan(model_dir, "cpu")
    with torch.no_grad():
        got = net(nchw(x))
    assert got.shape == (1, 3, 32, 32)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL)
    back = convert_rrdbnet({k: v.numpy() for k, v in
                            esrgan.state_dict_from_jax(esr).items()}, nb=1)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(esr)):
        assert np.array_equal(a, b)


def test_edit_and_stylize_video_match_jax(ldm):
    """FreePromptEditing (DDIM with the target half taking the source
    half's self-attention maps for the first steps) and cross-frame video
    stylization (img2img over 2 frames as one self-attention sequence) on
    JAX's draws of x_T and the img2img noise."""
    jax_app = _jax_app(ldm)
    app = _port_app(ldm)
    src = np.array([[2, 6, 7, 3, 0, 0, 0, 0]])
    tgt = np.array([[2, 8, 9, 3, 0, 0, 0, 0]])
    mask = (src > 0).astype(np.int32)
    rng = jax.random.PRNGKey(2)
    want = jax_app.edit(src, tgt, attention_mask=mask, num_steps=3,
                        guidance_scale=2.0, share_frac=0.5, rng=rng)
    x_t = jax.random.normal(rng, jax_app._latent_shape(1))
    got = app.edit(src, tgt, attention_mask=mask, num_steps=3,
                   guidance_scale=2.0, share_frac=0.5, x_init=nchw(x_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL)
    frames = np.random.RandomState(14).uniform(-1, 1, (2, 8, 8, 3)).astype(
        np.float32)
    want = jax_app.stylize_video(frames, src, num_steps=4, strength=0.5,
                                 guidance_scale=2.0, rng=rng,
                                 temporal_blend=0.3)
    noise = jax.random.normal(rng, (2, 8, 8, 4), jnp.float32)
    got = app.stylize_video(frames, src, num_steps=4, strength=0.5,
                            guidance_scale=2.0, temporal_blend=0.3,
                            noise=nchw(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL)


def test_non_bert_text_tower_reference_fault_33(ldm):
    """JAX's convert_stable_diffusion skips a text tower that is not a BERT
    (conversion.py:272-278: `except KeyError: pass`) and leaves its text
    encoder random; the port's normalize_keys raises."""
    from easynlp_tpu.modelzoo.models.latent_diffusion.conversion import (
        convert_stable_diffusion)
    _, kw, _, _, _ = ldm
    state = {k: v.numpy() for k, v in torch.load(os.path.join(
        ldm[0], "pytorch_model.bin")).items()
        if not k.startswith("cond_stage_model.")}
    state["cond_stage_model.transformer.text_model.embeddings."
          "token_embedding.weight"] = np.zeros((10, 8), np.float32)
    assert "text_encoder" not in convert_stable_diffusion(
        state, JM.LDMConfig(**kw))
    with pytest.raises(ValueError, match="not a BERT"):
        conversion.normalize_keys(state)


@pytest.mark.parametrize("task", [
    "latent_diffusion", "chinese-ldm-general", "chinese-ldm-fashion",
    "chinese-ldm-art", "chinese-ldm-poem", "chinese-ldm-anime",
    "chinese-ldm-pet", "chinese-ldm-food", "stable-diffusion-general"])
def test_diffusion_pipeline_tasks_resolve(ldm, task):
    """The nine PAI-Diffusion tasks (the JAX package's) build the port's
    StableDiffusionPipeline on a model directory."""
    from easynlp_tpu_torch.pipelines import SUPPORTED_TASKS, pipeline
    assert SUPPORTED_TASKS[task] == {"app": "latent_diffusion",
                                     "diffusion": True}
    pipe = pipeline(task, model_path=ldm[0], device="cpu")
    assert isinstance(pipe._diffusion, PM.StableDiffusionPipeline)
    assert pipe._diffusion.esrgan is not None  # the directory's ESRGAN
