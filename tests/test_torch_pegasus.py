"""The port's Pegasus, Randeng and dialogue `transformer` (the BART stack
under their configs' switches) against the JAX package's, on the CPU.

Each family gets one tiny model (2 + 2 layers, d_model 32, 4 heads, FFN
64, vocab 120, dropout 0) with HF-named weights drawn with numpy from a
seed (test_torch_bart.hf_state_dict, its position tables cut to the
family's size or dropped where the positions are sinusoidal, a final
LayerNorm per stack where the family has one); the JAX model takes them
through its own conversion, the port through bart/conversion.py. Bounds at
f32: logits within 1e-4 absolute, the loss within 1e-5 relative, each
gradient within 1e-4 of its largest entry, greedy and 4-beam generation
token for token (Pegasus and the post-LN dialogue transformer). Pegasus also at a
520-token source (the flash path's plain twins, with a gradient) and
against HF's PegasusForConditionalGeneration.
The dialogue app's loss_fn and chat against JAX's OpenDomainDialogue, and
ROADMAP reference fault 24 (the JAX app cannot load a `transformer`
checkpoint).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.appzoo.open_domain_dialogue.model import (
    OpenDomainDialogue as JaxDialogue,
)
from easynlp_tpu.modelzoo.models.bart import (
    BartForConditionalGeneration as JaxBart,
)
from easynlp_tpu.modelzoo.models.bart.configuration_bart import (
    PegasusConfig as JaxPegasusConfig,
)
from easynlp_tpu.modelzoo.models.bart.configuration_bart import (
    RandengConfig as JaxRandengConfig,
)
from easynlp_tpu.modelzoo.models.bart.conversion import convert_bart_state_dict
from easynlp_tpu.modelzoo.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from easynlp_tpu.modelzoo.seq2seq_generation import (
    encoder_decoder_generate as jax_generate,
)
from test_torch_bart import TINY, hf_state_dict

from easynlp_tpu_torch.appzoo.open_domain_dialogue.model import (
    OpenDomainDialogue,
)
from easynlp_tpu_torch.modelzoo.models.bart import (
    BartForConditionalGeneration,
    PegasusConfig,
    RandengConfig,
)
from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
    normalize_keys,
    state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.pegasus import (
    PegasusForConditionalGeneration,
)
from easynlp_tpu_torch.modelzoo.models.randeng import (
    RandengForConditionalGeneration,
)
from easynlp_tpu_torch.modelzoo.models.transformer import (
    TransformerConfig,
    TransformerGeneratorModel,
)
from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
    encoder_decoder_generate,
)

ATOL = 1e-4
DIALOGUE_TINY = dict(vocab_size=120, embedding_size=32, ffn_size=64,
                     n_layers=2, n_heads=4, n_positions=600, dropout=0.0)
# family -> (port config, JAX config, kwargs, port model class)
FAMILIES = {
    "pegasus": (PegasusConfig, JaxPegasusConfig, TINY,
                PegasusForConditionalGeneration),
    "randeng": (RandengConfig, JaxRandengConfig, TINY,
                RandengForConditionalGeneration),
    "transformer": (TransformerConfig, JaxTransformerConfig, DIALOGUE_TINY,
                    TransformerGeneratorModel),
    "transformer-prelayernorm": (
        TransformerConfig, JaxTransformerConfig,
        dict(DIALOGUE_TINY, variant="prelayernorm"),
        TransformerGeneratorModel),
}


def family_state_dict(config, seed=0):
    """HF-named weights of the family's layout from `seed`, the shared
    embedding scaled to 0.15 std (so the layers, not the last token's
    embedding, decide what a random model generates)."""
    state = hf_state_dict(config, seed)
    shared = 0.3 * state["model.shared.weight"]
    state["model.shared.weight"] = state["lm_head.weight"] = shared
    rng = np.random.RandomState(seed + 100)
    for side in ("encoder", "decoder"):
        pre = "model.%s." % side
        state[pre + "embed_tokens.weight"] = shared
        if config.position_type == "learned":
            rows = config.max_position_embeddings + config.position_offset
            state[pre + "embed_positions.weight"] = \
                state[pre + "embed_positions.weight"][:rows]
        if config.final_layer_norm:
            e = config.d_model
            state[pre + "layer_norm.weight"] = (
                1.0 + 0.1 * rng.standard_normal(e)).astype(np.float32)
            state[pre + "layer_norm.bias"] = (
                0.05 * rng.standard_normal(e)).astype(np.float32)
    return state


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    port_cfg, jax_cfg, kwargs, model_cls = FAMILIES[request.param]
    jax_config = jax_cfg(**kwargs)
    config = port_cfg(**kwargs)
    state = family_state_dict(config)
    model = model_cls(config).eval()
    model.load_state_dict(normalize_keys(
        {k: torch.from_numpy(v) for k, v in state.items()}, config),
        strict=True)
    params = convert_bart_state_dict(state, jax_config)
    return (request.param, JaxBart.from_config(jax_config, dtype=jnp.float32),
            params, model)


def _batch(seed, lengths, width, pad, vocab=120):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, vocab, (len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, pad).astype(np.int32), mask


def test_layouts():
    """Each family's switches, as the JAX configs set them."""
    for name, (port_cfg, jax_cfg, kwargs, _) in FAMILIES.items():
        a, b = port_cfg(**kwargs), jax_cfg(**kwargs)
        for key in ("normalize_before", "position_type", "position_offset",
                    "scale_embedding", "use_layernorm_embedding",
                    "final_layer_norm", "pad_token_id", "eos_token_id",
                    "decoder_start_token_id", "d_model", "encoder_layers"):
            assert getattr(a, key) == getattr(b, key), (name, key)
    assert TransformerConfig(**DIALOGUE_TINY).normalize_before is False
    assert TransformerConfig(**DIALOGUE_TINY,
                             learn_positional_embeddings=False) \
        .position_type == "sinusoidal"


@pytest.mark.parametrize("family,lengths,width,dec_lengths", [
    (name, [9, 4], 9, [5, 2]) for name in sorted(FAMILIES)] + [
    ("pegasus", [520, 300], 520, [7, 3])], indirect=["family"])
def test_logits_match_jax(family, lengths, width, dec_lengths):
    name, jax_model, params, model = family
    pad = model.config.pad_token_id
    ids, mask = _batch(0, lengths, width, pad)
    dec, dec_mask = _batch(1, dec_lengths, max(dec_lengths), pad)
    want = jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), decoder_input_ids=jnp.asarray(dec),
        decoder_attention_mask=jnp.asarray(dec_mask), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(dec), torch.from_numpy(dec_mask))
    np.testing.assert_allclose(got["encoder_last_hidden_state"].numpy(),
                               np.asarray(want["encoder_last_hidden_state"]),
                               atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize("family", ["pegasus", "transformer",
                                    "transformer-prelayernorm"],
                         indirect=True)
def test_loss_and_gradients_match_jax(family):
    """The dialogue app's loss_fn (JAX's and the port's), on both layouts
    and both dialogue variants (Randeng is Pegasus's graph under another
    config); Pegasus's batch has a 520-token source, so its encoder and cross-attention take the
    flash path's twins with a gradient: the loss within 1e-5 relative,
    every gradient within 1e-4 of its largest entry, or within 1e-6: the
    key projections' biases get no true gradient (softmax ignores a
    constant per row), only rounding noise of up to ~2e-7."""
    name, jax_model, params, model = family
    pad = model.config.pad_token_id
    width = 520 if name == "pegasus" else 24
    ids, mask = _batch(2, [width, width // 2], width, pad)
    dec, dec_mask = _batch(3, [6, 3], 6, pad)
    labels = np.where(dec_mask == 1, np.roll(dec, -1, axis=1),
                      -100).astype(np.int32)

    def jax_loss(p):
        out = jax_model.apply(
            {"params": p}, input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(mask),
            decoder_input_ids=jnp.asarray(dec),
            decoder_attention_mask=jnp.asarray(dec_mask), deterministic=True)
        return JaxDialogue.loss_fn(out, {"labels": jnp.asarray(labels)})[
            "loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    model.zero_grad()
    out = model(torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(dec), torch.from_numpy(dec_mask))
    loss = OpenDomainDialogue.loss_fn(
        out, {"labels": torch.from_numpy(labels).long()})["loss"]
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      want_grads),
                               model.config)
    for key, p in model.named_parameters():
        w = want[key].numpy().reshape(p.shape)
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=max(1e-4 * np.abs(w).max(), 1e-6),
                                   err_msg=(name, key))


@pytest.mark.parametrize("family", ["pegasus", "transformer"],
                         indirect=True)
@pytest.mark.parametrize("num_beams", [1, 4])
def test_generation_matches_jax(family, num_beams):
    """Token for token, on both layouts (Randeng is Pegasus's graph, the
    pre-LN dialogue variant the post-LN one's with the norms moved); the
    pad id is banned (bad_words_mask), which the random tiny Pegasus
    otherwise picks at every step."""
    name, jax_model, params, model = family
    pad = model.config.pad_token_id
    ids, mask = _batch(4, [11, 6, 9], 11, pad)
    banned = np.zeros(120, bool)
    banned[pad] = True
    want = np.asarray(jax_generate(jax_model, params, jnp.asarray(ids),
                                   jnp.asarray(mask), max_length=10,
                                   num_beams=num_beams,
                                   bad_words_mask=jnp.asarray(banned)))
    with torch.inference_mode():
        got = encoder_decoder_generate(
            model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
            max_length=10, num_beams=num_beams,
            bad_words_mask=torch.from_numpy(banned)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(set(got[:, 1:].ravel().tolist())) >= 2  # not a vacuous run


def test_state_dict_from_jax_round_trip(family):
    _, _, params, model = family
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               model.config)
    got = model.state_dict()
    assert set(back) == set(got)
    for k, v in back.items():
        torch.testing.assert_close(v, got[k], atol=0, rtol=0, msg=k)


def test_hf_pegasus_loads_strictly(monkeypatch):
    """transformers' PegasusForConditionalGeneration state dict (its
    sinusoidal tables included) loads strictly, and its logits match
    within 1e-4 (scale_embedding as google/pegasus-large's config.json
    sets it; HF's default is False)."""
    from test_torch_t5 import _transformers
    transformers = _transformers(monkeypatch)
    cfg = dict(vocab_size=120, d_model=32, encoder_layers=2,
               decoder_layers=2, encoder_attention_heads=4,
               decoder_attention_heads=4, encoder_ffn_dim=64,
               decoder_ffn_dim=64, max_position_embeddings=64, dropout=0.0,
               attention_dropout=0.0, activation_dropout=0.0,
               pad_token_id=0, eos_token_id=1, decoder_start_token_id=0,
               scale_embedding=True)
    torch.manual_seed(0)
    hf = transformers.PegasusForConditionalGeneration(
        transformers.PegasusConfig(**cfg)).eval()
    config = PegasusConfig(**cfg)
    model = BartForConditionalGeneration(config).eval()
    model.load_state_dict(normalize_keys(hf.state_dict(), config),
                          strict=True)
    ids, mask = _batch(5, [9, 5], 9, 0)
    dec, _ = _batch(6, [4, 4], 4, 0)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask),
                  decoder_input_ids=torch.from_numpy(dec).long()).logits
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(dec))["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def _jax_dialogue(params, jax_config, jax_model):
    return JaxDialogue(jax_model, params, jax_config)


def test_dialogue_chat_matches_jax(tmp_path):
    """OpenDomainDialogue.chat: the turns joined by " [SEP] ", tokenised
    by the dialogue tokenizer, generated with 3 beams and decoded: the JAX
    app's reply, word for word."""
    from easynlp_tpu.modelzoo.models.transformer import (
        TransformerTokenizer as JaxTokenizer)
    from test_torch_sentencepiece import write_transformer_tokenizer

    from easynlp_tpu_torch.modelzoo.models.transformer import (
        TransformerTokenizer)
    vocab_size = write_transformer_tokenizer(str(tmp_path))
    kwargs = dict(DIALOGUE_TINY, vocab_size=vocab_size)
    config = TransformerConfig(**kwargs)
    jax_config = JaxTransformerConfig(**kwargs)
    state = family_state_dict(config, seed=7)
    model = TransformerGeneratorModel(config).eval()
    model.load_state_dict(normalize_keys(
        {k: torch.from_numpy(v) for k, v in state.items()}, config),
        strict=True)
    params = convert_bart_state_dict(state, jax_config)
    jax_app = _jax_dialogue(params, jax_config,
                            JaxBart.from_config(jax_config,
                                                dtype=jnp.float32))
    app = OpenDomainDialogue(model, config, "cpu")
    history = ["hello there", "the model, then the other!"]
    for beams in (1, 3):
        got = app.chat(history, TransformerTokenizer.from_pretrained(
            str(tmp_path)), max_length=12, num_beams=beams)
        want = jax_app.chat(history, JaxTokenizer.from_pretrained(
            str(tmp_path)), max_length=12, num_beams=beams,
            jit_compile=False)
        assert got == want, beams
        assert got


def test_dialogue_reference_fault_24(tmp_path):
    """ROADMAP reference fault 24: the JAX OpenDomainDialogue takes its
    backbones from sequence_generation's BACKBONES, which has no
    `transformer`, so its load_config (and so the JAX CLI) fails on the
    family the app exists for. The port's app loads it."""
    (tmp_path / "config.json").write_text(json.dumps(
        dict(DIALOGUE_TINY, model_type="transformer")))
    with pytest.raises(KeyError, match="transformer"):
        JaxDialogue.load_config(str(tmp_path))
    config = OpenDomainDialogue.load_config(str(tmp_path))
    assert isinstance(config, TransformerConfig)
    assert config.d_model == 32 and config.decoder_layers == 2
    # the config.json a checkpoint writes reads back (JAX's
    # TransformerConfig takes d_model and the rest twice from its own
    # to_dict())
    config.save_pretrained(str(tmp_path / "ckpt"))
    again = OpenDomainDialogue.load_config(str(tmp_path / "ckpt"))
    assert again.to_dict() == config.to_dict()
    with pytest.raises(TypeError, match="multiple values"):
        JaxTransformerConfig.from_pretrained(str(tmp_path / "ckpt"))
    module = OpenDomainDialogue.build_module(config)
    assert isinstance(module, TransformerGeneratorModel)
