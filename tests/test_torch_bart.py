"""The port's BART against the JAX package's.

One tiny BART (2 + 2 layers, d_model 32, 4 heads, vocab 120) gets
HF-named weights drawn with numpy from a seed (random biases and LayerNorm
parameters too); the JAX model takes them through its
convert_bart_state_dict, the port through conversion.normalize_keys. Bound:
logits within 1e-4 at f32 (the two frameworks sum in other orders; the
logits are O(1)), padded and unpadded sources, short ones and one of 520
tokens, whose encoder and cross-attention take the port's flash path. At f32
the logits agree far inside the gaps between the top tokens, so greedy and
beam generation must give the same tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.modelzoo.models.bart import BartConfig as JaxBartConfig
from easynlp_tpu.modelzoo.models.bart import (
    BartForConditionalGeneration as JaxBart,
)
from easynlp_tpu.modelzoo.models.bart.conversion import convert_bart_state_dict
from easynlp_tpu.modelzoo.seq2seq_generation import (
    encoder_decoder_generate as jax_generate,
)
from easynlp_tpu_torch.modelzoo.models.bart import (
    BartConfig,
    BartForConditionalGeneration,
    PegasusConfig,
)
from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
    normalize_keys,
    state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
    encoder_decoder_generate,
)

TINY = dict(vocab_size=120, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_position_embeddings=600, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0)
ATOL = 1e-4


def hf_state_dict(config, seed=0):
    """HF BartForConditionalGeneration names and shapes (model. prefix, the
    tied shared/embed_tokens/lm_head, final_logits_bias [1,V]), numpy
    values from `seed`."""
    rng = np.random.RandomState(seed)
    c = config
    e, v = c.d_model, c.vocab_size
    s = {}

    def put(name, *shape, scale=0.05, base=0.0):
        s[name] = (base + scale * rng.standard_normal(shape)).astype(
            np.float32)

    put("model.shared.weight", v, e, scale=0.5)
    for side, n in (("encoder", c.encoder_layers),
                    ("decoder", c.decoder_layers)):
        pre = "model.%s." % side
        s[pre + "embed_tokens.weight"] = s["model.shared.weight"]
        put(pre + "embed_positions.weight",
            c.max_position_embeddings + 2, e, scale=0.5)
        put(pre + "layernorm_embedding.weight", e, scale=0.1, base=1.0)
        put(pre + "layernorm_embedding.bias", e)
        attns = ("self_attn", "encoder_attn") if side == "decoder" \
            else ("self_attn",)
        for i in range(n):
            lp = pre + "layers.%d." % i
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    put(lp + "%s.%s.weight" % (attn, proj), e, e, scale=0.2)
                    put(lp + "%s.%s.bias" % (attn, proj), e)
                put(lp + attn + "_layer_norm.weight", e, scale=0.1, base=1.0)
                put(lp + attn + "_layer_norm.bias", e)
            ffn = c.decoder_ffn_dim if side == "decoder" else c.encoder_ffn_dim
            put(lp + "fc1.weight", ffn, e, scale=0.2)
            put(lp + "fc1.bias", ffn)
            put(lp + "fc2.weight", e, ffn, scale=0.2)
            put(lp + "fc2.bias", e)
            put(lp + "final_layer_norm.weight", e, scale=0.1, base=1.0)
            put(lp + "final_layer_norm.bias", e)
    s["lm_head.weight"] = s["model.shared.weight"]
    put("final_logits_bias", 1, v, scale=0.1)
    return s


def _models(seed=0):
    jax_cfg = JaxBartConfig(**TINY)
    state = hf_state_dict(jax_cfg, seed)
    params = convert_bart_state_dict(state, jax_cfg)
    config = BartConfig(**TINY)
    model = BartForConditionalGeneration(config).eval()
    model.load_state_dict(normalize_keys(
        {k: torch.from_numpy(v) for k, v in state.items()}, config),
        strict=True)
    return JaxBart.from_config(jax_cfg, dtype=jnp.float32), params, model


@pytest.fixture(scope="module")
def tiny():
    return _models()


def _batch(seed, lengths, width, vocab=120):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 1).astype(np.int32), mask


@pytest.mark.parametrize("lengths,width,dec_lengths", [
    ([9, 9], 9, [5, 5]),          # unpadded
    ([9, 4], 9, [5, 2]),          # padded source and target
    ([520, 300], 520, [7, 3]),    # encoder and cross-attention past 512 keys
])
def test_logits_match_jax(tiny, lengths, width, dec_lengths):
    jax_model, params, model = tiny
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


def test_state_dict_from_jax_inverts_the_jax_conversion(tiny):
    """JAX params -> the port's state dict gives back the HF weights the
    JAX params were converted from (shared embedding untied per stack)."""
    _, params, model = tiny
    config = model.config
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               config)
    got = model.state_dict()
    assert set(back) == set(got)
    for k, v in back.items():
        torch.testing.assert_close(v, got[k], atol=0, rtol=0, msg=k)


def test_normalize_keys_takes_checkpoints_without_the_model_prefix(tiny):
    """A checkpoint saved from BartModel (no `model.` prefix, no head, no
    final_logits_bias) loads strictly: zeros for the bias."""
    _, _, model = tiny
    state = hf_state_dict(model.config)
    bare = {k[len("model."):]: torch.from_numpy(v) for k, v in state.items()
            if k.startswith("model.")}
    for side in ("encoder", "decoder"):
        bare.pop("%s.embed_tokens.weight" % side)
    norm = normalize_keys(bare, model.config)
    fresh = BartForConditionalGeneration(model.config)
    fresh.load_state_dict(norm, strict=True)
    assert not fresh.final_logits_bias.detach().any()
    torch.testing.assert_close(fresh.model.encoder.embed_tokens.weight,
                               torch.from_numpy(state["model.shared.weight"]))


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("lengths,width", [([9, 6], 9), ([520, 200], 520)])
def test_generation_matches_jax(tiny, num_beams, lengths, width):
    jax_model, params, model = tiny
    ids, mask = _batch(2, lengths, width)
    want = np.asarray(jax_generate(jax_model, params, jnp.asarray(ids),
                                   jnp.asarray(mask), max_length=12,
                                   num_beams=num_beams))
    with torch.inference_mode():
        got = encoder_decoder_generate(model, torch.from_numpy(ids).long(),
                                       torch.from_numpy(mask), max_length=12,
                                       num_beams=num_beams).numpy()
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:].ravel().tolist())) >= 2  # not a vacuous run


def test_post_ln_without_layernorm_embedding_matches_jax():
    """ROADMAP C12: a BART whose config turns off the embedding LayerNorm
    (use_layernorm_embedding=False, post-LN) builds none and applies none,
    as the JAX model does. The HF checkpoint still carries the weights; both
    conversions skip them. Logits within 1e-4 at f32 on a padded batch, and
    the JAX params convert back to the port's state dict."""
    cfg = dict(TINY, use_layernorm_embedding=False)
    jax_cfg = JaxBartConfig(**cfg)
    state = hf_state_dict(jax_cfg, seed=3)
    params = convert_bart_state_dict(state, jax_cfg)
    config = BartConfig(**cfg)
    model = BartForConditionalGeneration(config).eval()
    model.load_state_dict(normalize_keys(
        {k: torch.from_numpy(v) for k, v in state.items()}, config),
        strict=True)
    assert model.model.encoder.layernorm_embedding is None
    ids, mask = _batch(4, [9, 5], 9)
    dec, dec_mask = _batch(5, [6, 3], 6)
    want = JaxBart.from_config(jax_cfg, dtype=jnp.float32).apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), decoder_input_ids=jnp.asarray(dec),
        decoder_attention_mask=jnp.asarray(dec_mask), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(dec), torch.from_numpy(dec_mask))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               config)
    model.load_state_dict(back, strict=True)


def test_pegasus_layout_is_refused():
    with pytest.raises(NotImplementedError, match="A18"):
        BartForConditionalGeneration(PegasusConfig(**TINY))
