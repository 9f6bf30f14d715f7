"""The port's latent diffusion modules (slice 13, A22) against the JAX
package's, on the CPU.

A tiny LDM (image 16, UNet 16 channels over two levels with attention at
the second, 2 heads; a one-level VAE of 8 channels; a 1-layer BERT text
tower of width 16) is initialised by the JAX package and carried into the port
through conversion.state_dict_from_jax. The port follows CompVis where the
JAX modules depart from the CompVis code whose weights they convert
(ROADMAP reference faults 29-32); `Pair.port(jax_numerics=True)` builds
the port with JAX's choices instead (the transformer's GroupNorm eps
1e-5, LayerNorm eps 1e-6, tanh GELU; the VAE's symmetric down-sampling
pad), so everything else is held to JAX in f32 (bounds below):

- timestep_embedding, a ResBlock, the SpatialTransformer (plain,
  share_self's explicit maps, cross_frame's joint sequence, and head dim
  144 on the short path), the UNet with ControlNet residuals, the text
  tower, the VAE encoder and decoder (two levels);
- the DDIM, PLMS, DPM-Solver++ and img2img samplers on a closed-form
  denoiser given x_init, and DDIM with guidance through the whole model,
  JAX's x_T fed to the port;
- the training loss and every gradient given JAX's draws of t, the noise
  and the posterior's normals; the evaluator at JAX's per-batch draws;
- the attention twin at head dim 160 against JAX's `_short_attention`
  (Pallas, interpret mode), forward and gradients;
- reference faults 29-32, one test each.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.appzoo.latent_diffusion import model as JM
from easynlp_tpu.modelzoo.models.latent_diffusion import ddim as jddim
from easynlp_tpu.modelzoo.models.latent_diffusion import unet as junet
from easynlp_tpu_torch.appzoo.latent_diffusion import model as PM
from easynlp_tpu_torch.modelzoo.models.latent_diffusion import (
    autoencoder as pae,
    conversion,
    ddim as pddim,
    unet as punet,
)
from test_torch_text_match import _restore_global_args  # noqa: F401

TEXT = dict(vocab_size=60, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TINY = dict(image_size=16, model_channels=16, channel_mult=(1, 2),
            num_res_blocks=1, attention_levels=(1,), num_heads=2,
            context_dim=16, vae_channels=8, vae_channel_mult=(1,),
            vae_num_res_blocks=1, text_config=TEXT)
# f32 bounds: one layer's outputs (|x| ~ 1) within 2e-5; the UNet's noise
# prediction (|eps| ~ 1-3, ~20 layers) within 2e-5 + 1e-5 |x|; sampled
# latents after a few steps within 1e-4 (x0 = (x - sqrt(1 - a) eps) /
# sqrt(a) divides by sqrt(a) ~ 0.07 at the first step); gradients within
# 1e-5 + 1e-4 of the largest gradient of their tensor
ATOL, RTOL = 2e-5, 1e-5
SAMPLE_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
JAX_NUMERICS = {(punet, "TRANSFORMER_GN_EPS"): 1e-5,
                (punet, "TRANSFORMER_LN_EPS"): 1e-6,
                (punet, "GEGLU_APPROXIMATE"): "tanh",
                (pae, "VAE_DOWN_PAD"): (1, 1, 1, 1)}


@contextlib.contextmanager
def numerics(jax_like=True, only=None):
    """The port's module constants set to JAX's choices (all, or the keys in
    `only`) while modules are built."""
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), value in JAX_NUMERICS.items():
            if jax_like and (only is None or name in only):
                mp.setattr(mod, name, value)
        yield


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


class Pair:
    """The JAX module, its params (numpy) and a port module built from them
    through state_dict_from_jax."""

    def __init__(self, kw=TINY, seed=0):
        self.config = JM.LDMConfig(**kw)
        self.module = JM.LDMModule(config=self.config)
        self.params = np_tree(jax.jit(lambda: JM.LatentDiffusion.init_params(
            self.module, self.config, seed=seed))())
        self.port_config = PM.LDMConfig(**kw)

    def port(self, jax_numerics=True, only=None):
        with numerics(jax_numerics, only):
            module = PM.LDMModule(self.port_config)
        module.load_state_dict(PM.LatentDiffusion.state_dict_from_jax(
            self.params, self.port_config), strict=True)
        return module.eval()

    def app(self, jax_numerics=True):
        return PM.LatentDiffusion(self.port(jax_numerics), self.port_config,
                                  "cpu")

    def jax_app(self):
        return JM.LatentDiffusion(self.module, self.params, self.config)

    def apply(self, method, *args, **kw):
        fn = jax.jit(lambda p, *a: self.module.apply(
            {"params": p}, *a, method=getattr(self.module, method), **kw))
        return np.asarray(fn(self.params, *args))


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def port(pair):
    return pair.port()


def _text(seed, b=2, s=8):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, TEXT["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 5:] = 0
    return ids, mask


def _latents(seed, b=2, hw=16, c=4):
    return np.random.RandomState(seed).standard_normal(
        (b, hw, hw, c)).astype(np.float32)


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 500, 999], np.int32)
    close(punet.timestep_embedding(torch.from_numpy(t), dim).numpy(),
          junet.timestep_embedding(jnp.asarray(t), dim), atol=1e-6, rtol=0)


def test_resblock_matches_jax(pair):
    """ResBlock down_1_res0 (16 -> 32 channels, a 1x1 skip) on its own."""
    p = pair.params["unet"]["down_1_res0"]
    x = _latents(1, hw=8, c=16)
    temb = np.random.RandomState(2).standard_normal((2, 64)).astype(
        np.float32)
    want = jax.jit(lambda p, x, t: junet.ResBlock(32).apply(
        {"params": p}, x, t))(p, x, temb)
    sd = {}
    conversion._resblock(sd, "", p)
    block = punet.ResBlock(16, 32, 64)
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(nchw(x), torch.from_numpy(temb))
    close(nhwc(got), want)


@pytest.mark.parametrize("mode", ["plain", "share_self", "cross_frame",
                                  "head_dim_144"])
def test_spatial_transformer_matches_jax(pair, mode):
    """The level-1 transformer (32 channels, 2 heads of 16) over an 8 x 8
    grid: plain, with share_self's explicit shared maps, with cross_frame's
    joint self-attention over the batch; and a 288-channel transformer (2
    heads of 144: a head dim past 128 on the short path) over 4 x 4."""
    heads = 2
    if mode == "head_dim_144":
        c, hw = 288, 4
        params = np_tree(jax.jit(lambda: junet.SpatialTransformer(heads).init(
            jax.random.PRNGKey(3), jnp.zeros((2, hw, hw, c)),
            jnp.zeros((2, 5, 16)))["params"])())
    else:
        c, hw = 32, 8
        params = pair.params["unet"]["down_1_attn0"]
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kw = {"share_self": jnp.asarray(True)} if mode == "share_self" else {}
    want = jax.jit(lambda p, x, ctx: junet.SpatialTransformer(heads).apply(
        {"params": p}, x, ctx, cross_frame=mode == "cross_frame",
        **kw))(params, x, ctx)
    sd = {}
    conversion._spatial_transformer(sd, "", params)
    with numerics():
        st = punet.SpatialTransformer(c, heads, 16)
    st.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = st(nchw(x), context=torch.from_numpy(ctx),
                 share_self=torch.tensor(True) if kw else None,
                 cross_frame=mode == "cross_frame")
    close(nhwc(got), want)
    if mode == "share_self":  # the second half took the first half's maps
        with torch.no_grad():
            off = st(nchw(x), context=torch.from_numpy(ctx),
                     share_self=torch.tensor(False))
            plain = st(nchw(x), context=torch.from_numpy(ctx))
        close(off.numpy(), plain.numpy())
        assert (got[1] - off[1]).abs().max() > 1e-3
        close(got[0].numpy(), off[0].numpy())


def test_unet_with_control_residuals_matches_jax(pair, port):
    x = _latents(5)
    t = np.array([999, 10], np.int32)
    ids, mask = _text(6)
    ctx = pair.apply("encode_text", ids, mask)
    with torch.no_grad():
        pctx = port.encode_text(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
    close(pctx.numpy(), ctx)
    rng = np.random.RandomState(7)
    # skips: conv_in (16 @ 16x16), down_0 (16 @ 16x16), the downsample
    # (16 @ 8x8), down_1 (32 @ 8x8); the middle 32 @ 8x8
    shapes = [(2, 16, 16, 16), (2, 16, 16, 16), (2, 8, 8, 16), (2, 8, 8, 32)]
    downs = [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    mid = 0.1 * rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    want = jax.jit(lambda p, x, t, c, d, m: pair.module.apply(
        {"params": p}, x, t, c, control=(d, m),
        method=pair.module.predict_noise))(pair.params, x, t, ctx, downs, mid)
    with torch.no_grad():
        got = port.predict_noise(nchw(x), torch.from_numpy(t).long(),
                                 torch.from_numpy(ctx), control=(
                                     [nchw(d) for d in downs], nchw(mid)))
        plain = port.predict_noise(nchw(x), torch.from_numpy(t).long(),
                                   torch.from_numpy(ctx))
    close(nhwc(got), want)
    assert (got - plain).abs().max() > 1e-3


def test_vae_encoder_and_decoder_match_jax():
    """A two-level VAE (a down-sampling conv and an upsampling one), built
    with JAX's symmetric down-sampling pad: the moments, the posterior
    sample given JAX's normals, and the decode."""
    kw = dict(TINY, vae_channel_mult=(1, 2))
    jcfg = JM.LDMConfig(**kw)
    from easynlp_tpu.modelzoo.models.latent_diffusion.autoencoder import (
        VAEDecoder, VAEEncoder)
    pix = np.random.RandomState(8).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    lat = np.random.RandomState(9).standard_normal((2, 8, 8, 4)).astype(
        np.float32)

    def run():
        enc = VAEEncoder(jcfg)
        dec = VAEDecoder(jcfg)
        pe = enc.init(jax.random.PRNGKey(1), pix)["params"]
        pd = dec.init(jax.random.PRNGKey(2), lat)["params"]
        return pe, pd, enc.apply({"params": pe}, pix), dec.apply(
            {"params": pd}, lat)
    pe, pd, (mean, logvar), img = jax.jit(run)()
    cfg = PM.LDMConfig(**kw)
    with numerics():
        vae = pae.AutoencoderKL(cfg)
    vae.load_state_dict(conversion.vae_state_dict_from_jax(
        np_tree(pe), np_tree(pd), cfg), strict=True)
    with torch.no_grad():
        pmean, plogvar = vae.moments(nchw(pix))
        pimg = vae.decode(nchw(lat))
    close(nhwc(pmean), mean)
    close(nhwc(plogvar), logvar)
    close(nhwc(pimg), img)


def _closed_form_denoisers():
    """The same noise predictor in JAX and torch: a smooth function of x
    and t, so the samplers' arithmetic is tested alone."""
    def jax_fn(x, t):
        return jnp.tanh(x) * 0.5 + (t.astype(jnp.float32) / 1000.0)[
            :, None, None, None] * x
    def port_fn(x, t):
        return torch.tanh(x) * 0.5 + (t.float() / 1000.0)[
            :, None, None, None] * x
    return jax_fn, port_fn


@pytest.mark.parametrize("method", ["ddim", "plms", "dpm++", "img2img"])
def test_samplers_match_jax_given_x_init(method):
    jfn, pfn = _closed_form_denoisers()
    jsched, psched = jddim.DiffusionSchedule(), pddim.DiffusionSchedule()
    close(psched.alphas_cumprod.numpy(), jsched.alphas_cumprod, atol=0,
          rtol=0)
    x = _latents(10, hw=4)
    steps = 7
    if method == "img2img":
        noise = _latents(11, hw=4)
        # JAX draws its noise from the rng: the port takes that draw
        rng = jax.random.PRNGKey(0)
        jnoise = np.asarray(jax.random.normal(rng, x.shape, jnp.float32))
        want = jax.jit(lambda x: jddim.ddim_img2img(
            jfn, x, jsched, strength=0.6, num_steps=steps, rng=rng))(x)
        got = pddim.ddim_img2img(pfn, nchw(x), psched, strength=0.6,
                                 num_steps=steps, noise=nchw(jnoise))
        del noise
    else:
        jsample = {"ddim": jddim.ddim_sample, "plms": jddim.plms_sample,
                   "dpm++": jddim.dpm_solver_pp_sample}[method]
        psample = {"ddim": pddim.ddim_sample, "plms": pddim.plms_sample,
                   "dpm++": pddim.dpm_solver_pp_sample}[method]
        want = jax.jit(lambda x: jsample(jfn, x.shape, jsched,
                                         num_steps=steps, x_init=x))(x)
        got = psample(pfn, (2, 4, 4, 4), psched, num_steps=steps,
                      x_init=nchw(x))
    close(nhwc(got), want, atol=1e-5, rtol=1e-5)


def test_guided_ddim_through_the_model_matches_jax(pair):
    """JAX's make_sampler (DDIM, guidance 3, an all-PAD unconditioned
    prompt, the VAE decode) against the port's sample on JAX's x_T."""
    ids, mask = _text(12)
    rng = jax.random.PRNGKey(5)
    shape = pair.jax_app()._latent_shape(2)
    x_t = np.asarray(jax.random.normal(rng, shape, jnp.float32))
    neg = np.zeros_like(ids)
    sampler = jax.jit(pair.jax_app().make_sampler(num_steps=4,
                                                  guidance_scale=3.0))
    want = np.asarray(sampler(pair.params, ids, mask, neg, rng))
    app = pair.app()
    got = app.sample(ids, mask, num_steps=4, guidance_scale=3.0,
                     x_init=nchw(x_t))
    close(got.numpy(), want, atol=SAMPLE_ATOL, rtol=0)


def _jax_training_draws(pair, rng, b, hw):
    """The draws JAX's make_train_loss makes from `rng`."""
    r_t, r_noise, r_vae, _ = jax.random.split(rng, 4)
    c = pair.config
    t = jax.random.randint(r_t, (b,), 0, c.num_train_timesteps)
    noise = jax.random.normal(r_noise, (b, hw, hw, c.latent_channels))
    post = jax.random.normal(r_vae, (b, hw, hw, c.latent_channels))
    return {"t": torch.from_numpy(np.asarray(t)).long(),
            "noise": nchw(noise), "posterior": nchw(post)}


def test_training_loss_and_gradients_match_jax(pair):
    """make_train_loss's loss and every gradient (the gradient tree carried
    to the port's names by the same state_dict_from_jax) at JAX's draws."""
    ids, mask = _text(13)
    pix = np.random.RandomState(14).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    batch = {"input_ids": ids, "attention_mask": mask, "pixel_values": pix}
    rng = jax.random.PRNGKey(6)
    loss_fn = pair.jax_app().make_train_loss()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, batch, rng), has_aux=True))(pair.params)
    app = pair.app()
    app.module.train()
    draws = _jax_training_draws(pair, rng, 2, 16)
    tbatch = {"input_ids": torch.from_numpy(ids).long(),
              "attention_mask": torch.from_numpy(mask),
              "pixel_values": torch.from_numpy(pix)}
    got = app.diffusion_loss(tbatch, draws)
    got.backward()
    close(got.item(), float(loss), atol=1e-6, rtol=1e-5)
    want = PM.LatentDiffusion.state_dict_from_jax(np_tree(grads),
                                                  app.config)
    for name, p in app.module.named_parameters():
        w = want[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        np.testing.assert_allclose(
            g, w, rtol=0,
            atol=GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max()),
            err_msg=name)


def test_evaluator_matches_jax(pair, monkeypatch):
    """LDMEvaluator over 3 rows (a padded last batch of 2) at JAX's fixed
    per-batch draws: the same eval loss."""
    from easynlp_tpu.appzoo.latent_diffusion.evaluator import (
        LDMEvaluator as JaxEvaluator)
    from easynlp_tpu_torch.appzoo.latent_diffusion.evaluator import (
        LDMEvaluator)

    class Rows:
        def __init__(self, n):
            rng = np.random.RandomState(15)
            self.items = [{"input_ids": rng.randint(1, 60, 8).astype(
                np.int32), "attention_mask": np.ones(8, np.int32),
                "pixel_values": rng.uniform(-1, 1, (16, 16, 3)).astype(
                    np.float32)} for _ in range(n)]

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return self.items[i]

        def batch_fn(self, examples):
            return {k: np.stack([e[k] for e in examples])
                    for k in examples[0]}

    from easynlp_tpu.testing import make_args
    from test_torch_clip import _args
    want = JaxEvaluator(Rows(3), args=make_args(
        eval_batch_size=2)).evaluate(pair.jax_app())
    rngs = [jax.random.split(jax.random.PRNGKey(i)) for i in range(2)]

    def draws(app, index, b, hw):
        r_t, r_noise = rngs[index]
        t = jax.random.randint(r_t, (b,), 0, 1000)
        noise = jax.random.normal(r_noise, (b, hw, hw, 4), jnp.float32)
        return {"t": torch.from_numpy(np.asarray(t)).long(),
                "noise": nchw(noise), "posterior": None}
    monkeypatch.setattr(LDMEvaluator, "draws", staticmethod(draws))
    got = LDMEvaluator(Rows(3), args=_args(eval_batch_size=2)).evaluate(
        pair.app())
    assert got[0][0] == want[0][0] == "eval_loss"
    close(got[0][1], want[0][1], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", ["middle-64x64", "level2-256x32"])
def test_attention_twin_at_head_dim_160_matches_jax_short_kernel(case):
    """attention(impl='short') at head dim 160 (the port's plain twins on
    the CPU) against jax.grad of the JAX short kernel (Pallas, interpret
    mode): the middle block's 64 x 64 and level 2's cross-attention, 256
    queries over 32 keys, one row's keys ragged."""
    from test_torch_attention_bwd import (ATOL_SHORT, _inputs, _jax_grads,
                                          _port_grads, _via_attention)
    from easynlp_tpu.ops import attention as jax_attn
    sq, skv = (64, 64) if case.startswith("middle") else (256, 32)
    q, k, v, do, mask = _inputs(20, 2, sq, skv, 2, 160, [skv, skv - 5])
    want_o = np.asarray(jax_attn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask), impl="short"))
    got_o = _via_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(mask.astype(np.int32)), False)
    close(got_o.numpy(), want_o, atol=ATOL_SHORT, rtol=0)
    want = _jax_grads(q, k, v, do, mask, False, "short")
    got = _port_grads(q, k, v, do, mask, False, "bshd", _via_attention)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL_SHORT)


def test_vae_downsample_pad_reference_fault_29():
    """JAX's VAE down-sampling conv pads one pixel on every side
    (autoencoder.py:87-89); CompVis's Downsample pads the right and bottom
    edges only, then convolves with no padding. The port's conv equals a
    jax.lax.conv with (0, 1) padding on each axis and differs from the
    symmetric one by a half-pixel shift."""
    rng = np.random.RandomState(21)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32)  # HWIO
    b = np.zeros(4, np.float32)

    def lax_conv(pad):
        return np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
    down = pae.Downsample(4)
    sd = {}
    conversion._conv(sd, "conv", {"kernel": w, "bias": b})
    down.load_state_dict(sd)
    with torch.no_grad():
        got = nhwc(down(nchw(x)))
    assert pae.VAE_DOWN_PAD == (0, 1, 0, 1)
    close(got, lax_conv(((0, 1), (0, 1))), atol=1e-5, rtol=0)
    assert np.abs(got - lax_conv(((1, 1), (1, 1)))).max() > 1e-2


@pytest.mark.parametrize("fault,name,compvis", [
    (30, "GEGLU_APPROXIMATE", "none"),
    (31, "TRANSFORMER_GN_EPS", 1e-6),
    (32, "TRANSFORMER_LN_EPS", 1e-5)])
def test_transformer_numerics_reference_faults_30_to_32(pair, fault, name,
                                                        compvis):
    """JAX's SpatialTransformer computes its gated MLP with the tanh GELU
    (unet.py:140), its GroupNorm with the ResBlocks' eps 1e-5 (:32-36) and
    its LayerNorms with flax's eps 1e-6; CompVis's GEGLU uses the exact
    gelu, its Normalize eps 1e-6 and nn.LayerNorm eps 1e-5. The port takes
    CompVis's value of each: with JAX's value of this one it gives JAX's
    output, with CompVis's (its default) the output moves."""
    assert getattr(punet, name) == compvis
    params = dict(pair.params["unet"]["down_1_attn0"])
    # small activations before each norm, so that its eps shows: a small
    # input (GroupNorm) and a small proj_in (the first LayerNorm)
    params["proj_in"] = {"kernel": 1e-2 * params["proj_in"]["kernel"],
                         "bias": 0 * params["proj_in"]["bias"]}
    rng = np.random.RandomState(22)
    x = 1e-2 * rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = jax.jit(lambda p, x, c: junet.SpatialTransformer(2).apply(
        {"params": p}, x, c))(params, x, ctx)
    sd = {}
    conversion._spatial_transformer(sd, "", params)
    out = {}
    for jax_value in (True, False):
        others = [n for _, n in JAX_NUMERICS if n != name]
        with numerics(only=others + ([name] if jax_value else [])):
            st = punet.SpatialTransformer(32, 2, 16)
        st.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[jax_value] = nhwc(st(nchw(x), context=torch.from_numpy(ctx)))
    close(out[True], want)
    # CompVis's value moves the output by 5e-4 (30), 9e-2 (31), 0.39 (32)
    assert np.abs(out[False] - np.asarray(want)).max() > 10 * ATOL
