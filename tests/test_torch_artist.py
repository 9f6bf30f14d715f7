"""The port's ARTIST (modelzoo/models/artist/, the text2image app's module
and enable_vqgan's image-first tower) against the JAX package's, on the
CPU.

Two configurations: tests/test_multimodal.py's tiny one (2 VQGAN levels
of width 8, 1 res block, a 32-code codebook of dim 8, a 1-layer GPT of
width 16; 8 x 8 pixels, 16 codes) and a deeper one (3 levels, 2 res
blocks, a 2-layer GPT of width 32 over 4 heads; 16 x 16 pixels, 16
codes). Each is initialised by the JAX package and carried into the port
through state_dict_from_jax. Held to JAX in f32, dropout off: the
forward's logits (1e-5), codes (exactly), vq_loss (1e-5 relative) and
reconstruction (1e-5); decode_codes (1e-5); every gradient of the
training loss (1e-5 + 1e-4 relative); greedy image codes token for token
(do_sample=False, and top_k=1 sampling, which keeps only the argmax); the
image-first order's logits, caption loss, gradients and greedy captions;
and the quantiser's argmin, which keeps the first of tied rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.appzoo.image2text_generation import vqgan_model as JV
from easynlp_tpu.appzoo.text2image_generation import model as JT
from easynlp_tpu.modelzoo.models.artist import modeling_artist as JA
from easynlp_tpu_torch.appzoo.image2text_generation import vqgan_model as PV
from easynlp_tpu_torch.appzoo.text2image_generation import model as PT
from easynlp_tpu_torch.modelzoo.models.artist import modeling_artist as PA
from test_torch_clip import np_tree

GPT_TINY = dict(n_positions=128, n_embd=16, n_layer=1, n_head=2,
                resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
CONFIGS = {
    # tests/test_multimodal.py:74-100's
    "tiny": (dict(text_vocab_size=60, image_vocab_size=32, codebook_dim=8,
                  vq_channels=8, vq_channel_mult=(1, 2), vq_num_res_blocks=1,
                  image_token_length=16, gpt_config=GPT_TINY), 8),
    "deep": (dict(text_vocab_size=60, image_vocab_size=48, codebook_dim=8,
                  vq_channels=8, vq_channel_mult=(1, 1, 2),
                  vq_num_res_blocks=2, image_token_length=16,
                  gpt_config=dict(GPT_TINY, n_embd=32, n_layer=2,
                                  n_head=4)), 16),
}
ATOL = 1e-5


def make_pair(name, jax_cls=JT.TextImageGeneration,
              port_cls=PT.TextImageGeneration, seed=2):
    """(JAX app, port app, image side) with the same weights."""
    from easynlp_tpu.testing import make_args
    make_args()
    kw, side = CONFIGS[name]
    jcfg = JA.ARTISTConfig(**kw)
    module = jax_cls.build_module(jcfg, dtype=jnp.float32)
    params = np_tree(jax.jit(lambda: jax_cls.init_params(  # one compile
        module, jcfg, seed=seed))())
    jax_app = jax_cls(module, params, jcfg)
    cfg = PA.ARTISTConfig(**kw)
    model = port_cls.build_module(cfg)
    model.load_state_dict(port_cls.state_dict_from_jax(params, cfg),
                          strict=True)
    return jax_app, port_cls(model.eval(), cfg, "cpu"), side


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return make_pair(request.param)


def _batch(seed, side, b=3, s=7, vocab=60):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    mask[0, 5:] = 0
    return {"input_ids": rng.randint(1, vocab, (b, s)).astype(np.int32),
            "attention_mask": mask,
            "pixel_values": (rng.rand(b, side, side, 3) * 2 - 1)
            .astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_forward(jax_app, batch):
    return jax.jit(lambda p, b: jax_app.module.apply({"params": p}, **b))(
        jax_app.params, {k: jnp.asarray(v) for k, v in batch.items()})


def test_forward_matches_jax(pair):
    """Logits over [text; codes + text_vocab], the codes, vq_loss (codebook
    + commitment + the reconstruction's MSE) and the reconstruction."""
    jax_app, app, side = pair
    batch = _batch(0, side)
    want = _jax_forward(jax_app, batch)
    with torch.no_grad():
        got = app.forward(_torch(batch))
    np.testing.assert_array_equal(got["image_codes"].numpy(),
                                  np.asarray(want["image_codes"]))
    np.testing.assert_array_equal(got["sequence"].numpy(),
                                  np.asarray(want["sequence"]))
    assert len(np.unique(got["image_codes"].numpy())) > 2
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               atol=ATOL, rtol=0)
    assert float(got["vq_loss"]) == pytest.approx(float(want["vq_loss"]),
                                                  rel=1e-5)


def test_decode_codes_matches_jax(pair):
    """Codes [B, h, w] -> pixels [B, H, W, 3] through the codebook and the
    VQGAN decoder (nearest 2x, then a conv, per level)."""
    jax_app, app, side = pair
    c = app.config
    h = side // 2 ** (len(c.vq_channel_mult) - 1)
    codes = np.random.RandomState(1).randint(0, c.image_vocab_size,
                                             (2, h, h)).astype(np.int32)
    want = jax.jit(lambda p, c: jax_app.module.apply(
        {"params": p}, c, method=JA.ARTISTModel.decode_codes))(
            jax_app.params, jnp.asarray(codes))
    got = app.module.decode_codes(torch.from_numpy(codes))
    assert got.shape == (2, side, side, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _grads_match(jax_app, app, batch, loss_fn_jax):
    def jax_loss(p):
        o = jax_app.module.apply({"params": p}, **{
            k: jnp.asarray(v) for k, v in batch.items()})
        return loss_fn_jax(o, batch)["loss"]
    want_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(jax_app.params)
    t = _torch(batch)
    loss = app.loss_fn(app.forward(t), t)["loss"]
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = type(app).state_dict_from_jax(np_tree(grads), app.config)
    for name, p in app.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=1e-4, err_msg=name)
    app.module.zero_grad()


def test_loss_gradients_match_jax(pair):
    """The training loss (the LM loss from position text_len - 1 on, plus
    vq_loss) and its gradient for every parameter, the VQGAN's through the
    straight-through estimator included, against jax.grad."""
    jax_app, app, side = pair
    _grads_match(jax_app, app, _batch(2, side),
                 JT.TextImageGeneration.loss_fn)


def test_greedy_codes_match_jax(pair):
    """generate() after right-padded prompts, only image codes allowed:
    greedy, and top_k=1 sampling (the predictor's greedy), give JAX's
    greedy codes token for token."""
    jax_app, app, side = pair
    batch = _batch(3, side, b=4, s=6)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    want = np.asarray(jax_app.generate(jnp.asarray(ids), jnp.asarray(mask),
                                       do_sample=False))
    got = app.generate(ids, mask, do_sample=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.shape == (4, app.config.image_token_length)
    assert len(np.unique(got)) > 2
    sampled = app.generate(ids, mask, top_k=1,
                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(sampled.numpy(), want)


@pytest.fixture(scope="module")
def image_first():
    return make_pair("deep", JV.VQGANGPTImageTextGeneration,
                     PV.VQGANGPTImageTextGeneration)


def test_image_first_order_matches_jax(image_first):
    """enable_vqgan's tower: the sequence [codes + text_vocab; caption],
    its logits, the caption-side loss (padding left out by
    attention_mask) and every gradient."""
    jax_app, app, side = image_first
    batch = _batch(4, side)
    want = _jax_forward(jax_app, batch)
    with torch.no_grad():
        got = app.forward(_torch(batch))
    np.testing.assert_array_equal(got["sequence"].numpy(),
                                  np.asarray(want["sequence"]))
    assert int(got["sequence"][0, 0]) >= app.config.text_vocab_size
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)
    _grads_match(jax_app, app, batch,
                 JV.VQGANGPTImageTextGeneration.loss_fn)


@pytest.mark.parametrize("beams", [1, 3])
def test_image_first_captions_match_jax(image_first, beams):
    """Captions from BOS after the image-code prompt, the image codes
    banned: greedy and 3 beams, JAX's ids exactly."""
    jax_app, app, side = image_first
    pixels = _batch(5, side, b=3)["pixel_values"]
    kw = dict(max_length=6, bos_token_id=1, eos_token_id=2, num_beams=beams)
    want = np.asarray(jax_app.generate(pixels, **kw))
    got = app.generate(pixels, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 7) and (got[:, 0] == 1).all()
    assert (got < app.config.text_vocab_size).all()


def test_quantizer_argmin_keeps_the_first_tie():
    """Positions equidistant from two codebook rows (a row repeated, and
    two rows mirrored about the input) take the lower index, as
    jnp.argmin does; the codes, quantised vectors and loss equal JAX's
    VectorQuantizer's."""
    rng = np.random.RandomState(6)
    book = rng.standard_normal((6, 4)).astype(np.float32)
    book[4] = book[1]                   # an exact duplicate of row 1
    book[3] = -book[2]                  # rows 2 and 3 mirror about 0
    z = rng.standard_normal((1, 2, 2, 4)).astype(np.float32)
    z[0, 0, 0] = book[1]
    z[0, 1, 1] = 0.0                    # equidistant from rows 2 and 3
    vq = JA.VectorQuantizer(6, 4)
    want_q, want_codes, want_loss = vq.apply(
        {"params": {"codebook": jnp.asarray(book)}}, jnp.asarray(z))
    port = PA.VectorQuantizer(6, 4)
    with torch.no_grad():
        port.codebook.copy_(torch.from_numpy(book))
        got_q, got_codes, got_loss = port(
            torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    assert int(got_codes[0, 0, 0]) == 1
    d = ((book - z[0, 1, 1]) ** 2).sum(1)
    assert d[2] == d[3] and int(got_codes[0, 1, 1]) == int(d.argmin())
    np.testing.assert_allclose(got_q.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_q), atol=1e-6, rtol=0)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)
