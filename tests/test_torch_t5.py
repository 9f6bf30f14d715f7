"""The port's T5 / mT5 against the JAX package's and HF's, on the CPU.

A tiny T5 (2 + 2 layers, d_model 32, d_kv 8, 4 heads, FFN 64, vocab 120,
dropout 0) gets the port's HF-style initialisation moved by seeded noise;
the JAX model takes the weights through its convert_t5_state_dict (from the
port's HF-named state dict), so both hold the same values. Bounds at f32:
logits and the encoder output within 1e-4 absolute (O(1) values summed in
other orders), the loss within 1e-5 relative, each parameter's gradient
within 1e-4 of its largest entry; greedy and 4-beam generation token for
token. Both FFNs are covered (relu, and mT5's gated gelu); the untied mT5
head against HF's MT5ForConditionalGeneration, because the JAX model cannot
build one (ROADMAP reference fault 25). The bucket ids equal JAX's and HF's
at every distance in [-2048, 2048], both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.appzoo.sequence_generation.model import (
    SequenceGeneration as JaxApp,
)
from easynlp_tpu.modelzoo.models.t5 import MT5Config as JaxMT5Config
from easynlp_tpu.modelzoo.models.t5 import T5Config as JaxT5Config
from easynlp_tpu.modelzoo.models.t5 import (
    T5ForConditionalGeneration as JaxT5,
)
from easynlp_tpu.modelzoo.models.t5.conversion import convert_t5_state_dict
from easynlp_tpu.modelzoo.models.t5.modeling_t5 import (
    relative_position_buckets as jax_buckets,
)
from easynlp_tpu.modelzoo.seq2seq_generation import (
    encoder_decoder_generate as jax_generate,
)

from easynlp_tpu_torch.appzoo.sequence_generation.model import (
    SequenceGeneration,
)
from easynlp_tpu_torch.modelzoo.models.t5 import (
    MT5Config,
    T5Config,
    T5ForConditionalGeneration,
)
from easynlp_tpu_torch.modelzoo.models.t5.conversion import (
    normalize_keys,
    state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.t5.modeling_t5 import (
    relative_position_buckets,
)
from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
    encoder_decoder_generate,
)

T5_TINY = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_heads=4, dropout_rate=0.0)
ATOL = 1e-4
FAMILIES = {"t5": (T5Config, JaxT5Config, {}),
            "mt5-tied": (MT5Config, JaxMT5Config,
                         {"tie_word_embeddings": True})}


def port_model(config, seed=0):
    """The port's init from `seed`, every weight moved by 0.2 N(0, 1)
    (norm scales by 0.1) so no two tensors share values."""
    model = T5ForConditionalGeneration(config)
    model.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.1 if "layer_norm" in name else 0.2
            p.add_(torch.from_numpy(
                scale * rng.standard_normal(p.shape).astype(np.float32)))
    return model.eval()


def jax_params(model, jax_config):
    """The JAX params of the port's weights, through the JAX package's own
    HF conversion (HF keys: the stacks' embed_tokens copies added)."""
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    for side in ("encoder", "decoder"):
        state[side + ".embed_tokens.weight"] = state["shared.weight"]
    return convert_t5_state_dict(state, jax_config)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    port_cls, jax_cls, extra = FAMILIES[request.param]
    config = port_cls(**T5_TINY, **extra)
    jax_config = jax_cls(**T5_TINY, **extra)
    model = port_model(config)
    return (JaxT5.from_config(jax_config, dtype=jnp.float32),
            jax_params(model, jax_config), model)


def _batch(seed, lengths, width, vocab=120):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, (len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


def _transformers(monkeypatch):
    """transformers, imported without its TensorFlow and Flax integrations
    (which only slow the import here)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.setenv("USE_JAX", "0")
    import transformers
    return transformers


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_ids_match_jax_and_hf(bidirectional, monkeypatch):
    """Every distance in [-2048, 2048]: the JAX model's ids (f32 logs, the
    rounding at 16, 32 and 64 included) and HF T5's (no difference
    found, so no reference fault)."""
    _transformers(monkeypatch)
    from transformers.models.t5.modeling_t5 import T5Attention
    rel = torch.arange(-2048, 2049)
    got = relative_position_buckets(rel, bidirectional, 32, 128).numpy()
    want = np.asarray(jax_buckets(jnp.zeros((1,), jnp.int32),
                                  jnp.arange(-2048, 2049), bidirectional,
                                  32, 128))[0]
    np.testing.assert_array_equal(got, want)
    hf = T5Attention._relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=32, max_distance=128)
    np.testing.assert_array_equal(got, hf.numpy())
    # bidirectional: 16 buckets a side, of which bucket 16 (rel > 0 of the
    # exact part, which starts at rel = 1) is never reached; causal: 32
    assert len(set(got.tolist())) == (31 if bidirectional else 32)


@pytest.mark.parametrize("lengths,width,dec_lengths", [
    ([9, 4], 9, [5, 2]), ([200, 150], 200, [40, 17])])
def test_logits_match_jax(pair, lengths, width, dec_lengths):
    jax_model, params, model = pair
    ids, mask = _batch(0, lengths, width)
    dec, dec_mask = _batch(1, dec_lengths, max(dec_lengths))
    want = jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), decoder_input_ids=jnp.asarray(dec),
        decoder_attention_mask=jnp.asarray(dec_mask), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(dec), torch.from_numpy(dec_mask))
    np.testing.assert_allclose(got["encoder_last_hidden_state"].numpy(),
                               np.asarray(want["encoder_last_hidden_state"]),
                               atol=ATOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)


def test_loss_and_gradients_match_jax(pair):
    """Teacher-forced CE (-100 on the pads) through both apps' loss_fn:
    the loss within 1e-5 relative, every gradient within 1e-4 of its
    largest entry (JAX's gradient tree mapped onto the port's names by
    state_dict_from_jax)."""
    jax_model, params, model = pair
    ids, mask = _batch(2, [12, 7], 12)
    dec, dec_mask = _batch(3, [6, 3], 6)
    labels = np.where(dec_mask == 1, np.roll(dec, -1, axis=1), -100)
    batch = {"labels": labels.astype(np.int32)}

    def jax_loss(p):
        out = jax_model.apply(
            {"params": p}, input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(mask),
            decoder_input_ids=jnp.asarray(dec),
            decoder_attention_mask=jnp.asarray(dec_mask), deterministic=True)
        return JaxApp.loss_fn(out, {"labels": jnp.asarray(labels)})["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    model.zero_grad()
    out = model(torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(dec), torch.from_numpy(dec_mask))
    loss = SequenceGeneration.loss_fn(
        out, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss["loss"].backward()
    assert float(loss["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      want_grads),
                               model.config)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("num_beams", [1, 4])
def test_generation_matches_jax(pair, num_beams):
    """Token for token; the pad id is banned (bad_words_mask), which the
    random tiny model otherwise picks at every step."""
    jax_model, params, model = pair
    ids, mask = _batch(4, [11, 6, 9], 11)
    banned = np.zeros(120, bool)
    banned[0] = True
    want = np.asarray(jax_generate(jax_model, params, jnp.asarray(ids),
                                   jnp.asarray(mask), max_length=10,
                                   num_beams=num_beams,
                                   bad_words_mask=jnp.asarray(banned)))
    with torch.inference_mode():
        got = encoder_decoder_generate(
            model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
            max_length=10, num_beams=num_beams,
            bad_words_mask=torch.from_numpy(banned)).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:].ravel().tolist())) >= 3  # not a vacuous run


def test_cached_decode_matches_the_uncached_forward(pair):
    """Step-by-step decoding through the cache (self K/V written in place,
    the cross K/V precomputed, the bias row of the cache index) gives the
    teacher-forced forward's logits at every position (1e-5)."""
    _, _, model = pair
    ids, mask = _batch(5, [10, 7], 10)
    dec, _ = _batch(6, [6, 6], 6)
    src, src_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        want = model(src, src_mask, torch.from_numpy(dec))["logits"]
        enc = model.encode(src, src_mask)
        cache = model.init_cache(2, 8)
        cache.cross_k, cache.cross_v = model.precompute_cross_kv(enc)
        for t in range(dec.shape[1]):
            step, cache = model.decode(torch.from_numpy(dec[:, t:t + 1]),
                                       enc, src_mask, cache=cache)
            np.testing.assert_allclose(step[:, 0].numpy(),
                                       want[:, t].numpy(), atol=1e-5)
    assert cache.index == dec.shape[1]


def test_state_dict_from_jax_inverts_the_jax_conversion(pair):
    _, params, model = pair
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               model.config)
    got = model.state_dict()
    assert set(back) == set(got)
    for k, v in back.items():
        torch.testing.assert_close(v, got[k], atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("family", ["t5", "mt5"])
def test_hf_state_dict_loads_strictly(family, monkeypatch):
    """transformers' T5ForConditionalGeneration (tied, relu) and
    MT5ForConditionalGeneration (untied lm_head, gated gelu) state dicts
    load strictly through normalize_keys, with HF's logits within 1e-4."""
    transformers = _transformers(monkeypatch)
    hf_cls, port_cls = {
        "t5": (transformers.T5ForConditionalGeneration, T5Config),
        "mt5": (transformers.MT5ForConditionalGeneration, MT5Config)}[family]
    extra = {} if family == "t5" else {"tie_word_embeddings": False,
                                       "feed_forward_proj": "gated-gelu"}
    hf_config = (transformers.T5Config if family == "t5"
                 else transformers.MT5Config)(**T5_TINY, **extra,
                                              decoder_start_token_id=0)
    torch.manual_seed(0)
    hf = hf_cls(hf_config).eval()
    config = port_cls(**T5_TINY, **extra)
    model = T5ForConditionalGeneration(config).eval()
    model.load_state_dict(normalize_keys(hf.state_dict(), config),
                          strict=True)
    assert hasattr(model, "lm_head") == (family == "mt5")
    ids, mask = _batch(7, [9, 5], 9)
    dec, _ = _batch(8, [4, 4], 4)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask),
                  decoder_input_ids=torch.from_numpy(dec).long()).logits
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(dec))["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_untied_head_reference_fault_25():
    """ROADMAP reference fault 25: the JAX T5 builds its untied lm_head
    (mT5, tie_word_embeddings=False) inside decode(), a method of a
    setup()-style module, so flax refuses it and no mT5 checkpoint runs in
    the JAX package. The port's untied head runs and takes the gradient."""
    import flax
    config = JaxMT5Config(**T5_TINY, tie_word_embeddings=False)
    with pytest.raises(flax.errors.AssignSubModuleError):
        JaxApp.init_params(JaxT5.from_config(config, dtype=jnp.float32),
                           config)
    model = port_model(MT5Config(**T5_TINY, tie_word_embeddings=False))
    ids, mask = _batch(9, [6, 6], 6)
    out = model(torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(ids[:, :3]))
    assert out["logits"].dtype == torch.float32  # the head runs in f32
    out["logits"].sum().backward()
    assert model.lm_head.weight.grad.abs().sum() > 0


def test_remat_gives_the_same_gradients(pair):
    """--remat=full (modeling_bert.set_remat on T5's blocks) recomputes each
    block in the backward: the loss and every gradient bit for bit those
    of none."""
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    _, _, model = pair
    ids, mask = _batch(12, [10, 6], 10)
    dec, dec_mask = _batch(13, [5, 3], 5)
    args = [torch.from_numpy(a) for a in (ids, mask, dec, dec_mask)]
    grads = {}
    for policy in ("none", "full"):
        set_remat(model, policy)
        model.zero_grad()
        loss = model(*args)["logits"].float().logsumexp(-1).mean()
        loss.backward()
        grads[policy] = (loss.detach(), {n: p.grad.clone()
                                         for n, p in model.named_parameters()})
    set_remat(model, "none")
    assert torch.equal(grads["none"][0], grads["full"][0])
    for name, g in grads["none"][1].items():
        assert torch.equal(g, grads["full"][1][name]), name


def test_bf16_logits_stay_near_f32(pair):
    """bf16 compute on the same f32 weights: the logits' error against
    f32, relative to their rms, stays under 1e-1. T5's unscaled scores
    reach O(10) at these weights, and the self-attentions' plain path
    rounds the max-subtracted scores to bf16 (ROADMAP reference fault 3),
    up to 2^-8 x 10 = 0.04 off in a probability's exponent; each of the
    2 + 2 layers adds its projections' 2^-8 roundings (readings: < 3e-2 for
    T5, 4.9e-2 for the gated mT5)."""
    _, _, model = pair
    bf16 = T5ForConditionalGeneration(model.config, dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    ids, mask = _batch(10, [16, 11], 16)
    dec, dec_mask = _batch(11, [8, 5], 8)
    args = [torch.from_numpy(a) for a in (ids, mask, dec, dec_mask)]
    with torch.no_grad():
        want = model(*args)["logits"]
        got = bf16.eval()(*args)["logits"].float()
    err = (got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()
    assert float(err) < 1e-1
