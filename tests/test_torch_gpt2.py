"""The port's GPT-2 against the JAX package's.

Weights are initialised by the JAX package (TINY: 2 layers, n_embd 32,
vocab 97) and carried into the port with state_dict_from_jax, or written as
an HF pytorch_model.bin that both packages read. Inputs are made with numpy
from a seed. f32 bound 1e-4 on logits, the bound the BERT port is held to;
the two agree within ~1e-7 in practice (sums in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config as JaxGPT2Config
from easynlp_tpu.modelzoo.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from easynlp_tpu.modelzoo.models.gpt2.conversion import (
    convert_gpt2_state_dict,
)
from easynlp_tpu.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns as jax_generation_fns,
)
from easynlp_tpu.modelzoo.models.gpt2.tokenization_gpt2 import (
    GPT2Tokenizer as JaxGPT2Tokenizer,
)
from easynlp_tpu_torch.modelzoo.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    GPT2Tokenizer,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    normalize_keys,
    state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)
from easynlp_tpu_torch.ops import attention as A

TINY = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=2,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
ATOL = 1e-4


def _models(dtype=torch.float32, **overrides):
    cfg = dict(TINY, **overrides)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_model = JaxGPT2.from_config(JaxGPT2Config(**cfg), dtype=jdtype)
    rng = jax.random.PRNGKey(1)
    params = nn.unbox(jax_model.init(
        {"params": rng, "dropout": rng}, input_ids=jnp.ones((1, 4), jnp.int32),
        deterministic=True)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    config = GPT2Config(**cfg)
    model = GPT2LMHeadModel(config, dtype=dtype).eval()
    model.transformer.load_state_dict(state_dict_from_jax(params, config),
                                      strict=True)
    return jax_model, params, model


def _inputs(seed, b, s, pads, vocab=97):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, n in enumerate(pads):
        mask[row, :n] = 0   # left padding
        ids[row, :n] = 0
    return ids, mask


@pytest.mark.parametrize("pads", [[0, 0], [0, 4]], ids=["unpadded",
                                                       "left-padded"])
def test_full_forward_logits_match_jax(pads):
    """Every real position's logits within 1e-4. Pad positions are not
    compared: their query rows see no key, and both models give them the
    mean of V over the keys they attend, which feeds nothing."""
    jax_model, params, model = _models()
    ids, mask = _inputs(0, 2, 12, pads)
    want = np.asarray(jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), deterministic=True)["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask))["logits"]
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], want[real], atol=ATOL)


def test_bf16_forward_follows_jax_casts():
    """bf16 compute on f32 weights against JAX's bf16 model on the same
    weights. Both cast at the same points (embedding sum, f32 LayerNorm,
    bf16 projections and residual adds, bf16 head); their bf16 matmuls sum
    in other orders, which moves a bf16 activation by an ulp (2^-8
    relative). Logits here are |x| < 0.5: bound 2e-2."""
    jax_model, params, model = _models(dtype=torch.bfloat16)
    ids, mask = _inputs(1, 2, 12, [0, 3])
    want = np.asarray(jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask),
        deterministic=True)["logits"].astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask))["logits"]
    assert got.dtype == torch.bfloat16
    real = mask.astype(bool)
    np.testing.assert_allclose(got.float().numpy()[real], want[real],
                               atol=2e-2)


@pytest.mark.parametrize("n_positions,prompt,pads,steps", [
    (64, 9, [0, 3], 5),
    (1024, 560, [0, 70], 3),
], ids=["short", "past-512"])
def test_prefill_and_decode_match_jax(monkeypatch, n_positions, prompt, pads,
                                      steps):
    """Prefill logits (last position) and each decode step's logits within
    1e-4 of JAX make_gpt2_generation_fns. At 560 keys the port's prefill and
    decode run flash_attention_fwd (its plain twin on the CPU); JAX's take
    its XLA path (a bias over the cache slots)."""
    calls = []
    real = A.flash_attention_fwd_reference

    def spy(q, k, *a, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, *a, **kw)
    monkeypatch.setattr(A, "flash_attention_fwd_reference", spy)

    jax_model, params, model = _models(n_positions=n_positions)
    ids, mask = _inputs(2, 2, prompt + steps, pads)
    t = prompt + steps
    jax_prefill, jax_decode = jax_generation_fns(jax_model, t)
    prefill, decode = make_gpt2_generation_fns(model, t)
    want, jcache = jax_prefill(params, jnp.asarray(ids[:, :prompt]),
                               jnp.asarray(mask[:, :prompt]))
    with torch.no_grad():
        got, cache = prefill(torch.from_numpy(ids[:, :prompt]).long(),
                             torch.from_numpy(mask[:, :prompt]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        for s in range(prompt, t):
            want, jcache = jax_decode(params, jnp.asarray(ids[:, s:s + 1]),
                                      jcache)
            got, cache = decode(torch.from_numpy(ids[:, s:s + 1]).long(),
                                cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)
    np.testing.assert_array_equal(cache.mask.numpy(),
                                  np.asarray(jcache["mask"]))
    assert cache.index == int(jcache["index"]) == t
    if prompt > A.SHORT_MAX_KV_LEN:
        assert calls == [(prompt, prompt)] * 2 + [(1, t)] * (2 * steps)
    else:
        assert not calls


def test_prefill_hidden_states_match_jax_on_real_rows():
    """The prefill's hidden states at every real position, past 512 keys.
    The port attends over the prompt's own P keys, JAX over all T cache
    slots with the empty ones masked: a real query sees the same keys
    either way. A left-pad query sees none, and the two average V over P
    and over T keys: those rows differ and feed nothing (every real query
    masks their keys), so they are not compared."""
    jax_model, params, model = _models(n_positions=1024)
    ids, mask = _inputs(3, 2, 530, [0, 40])
    t = 540
    cache = jax_model.init_cache(2, t)
    cache["mask"] = cache["mask"].at[:, :530].set(jnp.asarray(mask))
    want = np.asarray(jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), cache=cache,
        deterministic=True)["logits"])
    with torch.no_grad():
        tcache = model.init_cache(2, t)
        tcache.mask[:, :530] = torch.from_numpy(mask)
        out = model(torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask), cache=tcache)
    real = mask.astype(bool)
    np.testing.assert_allclose(out["logits"].numpy()[real], want[real],
                               atol=ATOL)


def test_hf_checkpoint_loads_strictly_in_both(tmp_path):
    """An HF-named state dict (transformer. prefix, tied lm_head.weight,
    attn.bias / attn.masked_bias buffers): the port loads it strictly after
    normalize_keys, JAX through convert_gpt2_state_dict, and the logits
    agree."""
    rng = np.random.RandomState(4)
    config = GPT2Config(**TINY)
    model = GPT2LMHeadModel(config).eval()
    state = {"transformer." + k: torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.05)
        for k, v in model.transformer.state_dict().items()}
    state["lm_head.weight"] = state["transformer.wte.weight"]
    for i in range(config.n_layer):
        state["transformer.h.%d.attn.bias" % i] = torch.ones(1, 1, 64, 64)
        state["transformer.h.%d.attn.masked_bias" % i] = torch.tensor(-1e4)
    model.transformer.load_state_dict(normalize_keys(state), strict=True)
    jax_model = JaxGPT2.from_config(JaxGPT2Config(**TINY), dtype=jnp.float32)
    params = convert_gpt2_state_dict(
        {k: v.numpy() for k, v in state.items()}, JaxGPT2Config(**TINY))
    ids, mask = _inputs(5, 2, 10, [0, 2])
    want = np.asarray(jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), deterministic=True)["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask))["logits"].numpy()
    np.testing.assert_allclose(got[mask.astype(bool)],
                               want[mask.astype(bool)], atol=ATOL)
    with pytest.raises(RuntimeError, match="Missing key"):
        del state["transformer.ln_f.bias"]
        model.transformer.load_state_dict(normalize_keys(state), strict=True)


def test_tokenizer_gives_the_jax_ids(tmp_path):
    """A synthetic byte-level vocab with merges: the port's tokenizer and
    the JAX GPT2Tokenizer give the same ids on mixed text (ASCII words,
    digits, punctuation, contractions, spacing, CJK and accents), and
    decode them back to the text."""
    from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (
        bytes_to_unicode)
    symbols = list(bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"),
              ("e", "r"), ("Ġ", "m"), ("o", "d"), ("Ġm", "od"), ("e", "l")]
    vocab = {s: i for i, s in enumerate(symbols)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join("%s %s\n" % m for m in merges))
    texts = ["The model in the garden", "it's 2048 tokens; isn't it?",
             "  spaced   out\ttabs\n", "汉字 and café", "the the theater"]
    ours = GPT2Tokenizer.from_pretrained(str(tmp_path))
    theirs = JaxGPT2Tokenizer.from_pretrained(str(tmp_path))
    for text in texts:
        assert ours.tokenize(text) == theirs.tokenize(text)
    enc, jenc = ours(texts, max_length=12), theirs(texts, max_length=12)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(enc[key], jenc[key])
    assert ours.pad_token_id == theirs.pad_token_id == len(vocab) - 1
    ids = ours(texts[1], max_length=64)["input_ids"]
    assert ours.decode(ids) == texts[1] == theirs.decode(ids)


def test_unported_model_features_raise():
    with pytest.raises(NotImplementedError, match="A24"):
        GPT2LMHeadModel(GPT2Config(**dict(TINY, num_experts=4)))
    model = GPT2LMHeadModel(GPT2Config(**TINY)).eval()
    cache = model.init_cache(2, 16)
    cache.index = torch.tensor([3, 5])
    with pytest.raises(NotImplementedError, match="A17"), torch.no_grad():
        model(torch.ones((2, 1), dtype=torch.long), cache=cache)
    cache = model.init_cache(2, 16)
    cache.index = 4
    with pytest.raises(NotImplementedError, match="A16"), torch.no_grad():
        model(torch.ones((2, 3), dtype=torch.long), cache=cache)


def test_model_dir_round_trip(tmp_path):
    """SequenceGeneration.from_pretrained builds the model from config.json
    and a pytorch_model.bin written from the port's own state dict."""
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    _, _, model = _models()
    state = {"transformer." + k: v
             for k, v in model.transformer.state_dict().items()}
    torch.save(state, os.path.join(tmp_path, "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(
        dict(TINY, model_type="gpt2")))
    app = SequenceGeneration.from_pretrained(str(tmp_path), device="cpu")
    for k, v in app.module.transformer.state_dict().items():
        assert torch.equal(v, model.transformer.state_dict()[k]), k
