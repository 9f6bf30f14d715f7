"""The port's generation against the JAX package's.

One tiny GPT-2 (2 layers, n_embd 32, vocab 97) is initialised by the JAX
package and carried into the port with state_dict_from_jax. Prompts are made
with numpy and left-padded for both. At f32 the two models' logits agree
within 1e-6 (test_torch_gpt2.py), far inside the gaps between the top
tokens, so greedy and beam search must give the same tokens exactly. The
logits processors are held to JAX within 1e-6 on the same numpy logits.
Sampling draws from a torch.Generator, whose stream JAX cannot reproduce:
it is held to its processors and to determinism instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easynlp_tpu.modelzoo import generation_utils as J
from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config as JaxGPT2Config
from easynlp_tpu.modelzoo.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from easynlp_tpu.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns as jax_generation_fns,
)
from easynlp_tpu_torch.modelzoo import generation_utils as G
from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Config, GPT2LMHeadModel
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)
from easynlp_tpu_torch.ops import attention as A

TINY = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=2,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
PROC_ATOL = 1e-6


def _models(**overrides):
    cfg = dict(TINY, **overrides)
    jax_model = JaxGPT2.from_config(JaxGPT2Config(**cfg), dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = nn.unbox(jax_model.init(
        {"params": rng, "dropout": rng}, input_ids=jnp.ones((1, 4), jnp.int32),
        deterministic=True)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    config = GPT2Config(**cfg)
    model = GPT2LMHeadModel(config).eval()
    model.transformer.load_state_dict(state_dict_from_jax(params, config),
                                      strict=True)
    return jax_model, params, model


@pytest.fixture(scope="module")
def tiny():
    return _models()


def _prompts(seed, lengths, width, vocab=97):
    rng = np.random.RandomState(seed)
    return G.left_pad([list(rng.randint(1, vocab - 1, n)) for n in lengths],
                      0, length=width)


def _jax_generate(jax_model, params, ids, mask, max_length, **kw):
    prefill, decode = jax_generation_fns(jax_model, max_length)
    return np.asarray(J.generate(prefill, decode, params, jnp.asarray(ids),
                                 jnp.asarray(mask), max_length=max_length,
                                 **kw))


def _torch_generate(model, ids, mask, max_length, **kw):
    prefill, decode = make_gpt2_generation_fns(model, max_length)
    with torch.inference_mode():
        out = G.generate(prefill, decode, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), max_length=max_length, **kw)
    return out.numpy()


def test_left_pad_matches_jax():
    seqs = [[1, 2, 3], [4], [5, 6, 7, 8, 9]]
    for length in (None, 4, 6):
        got = G.left_pad(seqs, 0, length=length)
        want = J.left_pad(seqs, 0, length=length)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


PROCESSORS = {  # name: fn(module, logits, sequences, valid, bad, cur_len)
    "temperature": lambda m, lg, s, v, bad, n: m.apply_temperature(lg, 0.7),
    "top_k": lambda m, lg, s, v, bad, n: m.apply_top_k(lg, 5),
    "top_p": lambda m, lg, s, v, bad, n: m.apply_top_p(lg, 0.6),
    "repetition_penalty": lambda m, lg, s, v, bad, n:
        m.apply_repetition_penalty(lg, s, v, 1.3),
    "min_length": lambda m, lg, s, v, bad, n: m.apply_min_length(lg, n, 12, 7),
    "min_length_reached": lambda m, lg, s, v, bad, n:
        m.apply_min_length(lg, n, 9, 7),
    "no_repeat_ngram": lambda m, lg, s, v, bad, n:
        m.apply_no_repeat_ngram(lg, s, n, 2),
    "no_repeat_ngram_3": lambda m, lg, s, v, bad, n:
        m.apply_no_repeat_ngram(lg, s, n, 3),
    "bad_words_mask": lambda m, lg, s, v, bad, n:
        m.apply_bad_words_mask(lg, bad),
    "process_logits": lambda m, lg, s, v, bad, n: m.process_logits(
        lg, s, v, n, {"repetition_penalty": 1.2, "no_repeat_ngram_size": 2,
                      "min_length": 12, "eos_token_id": 3,
                      "bad_words_mask": bad}),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_logits_processor_matches_jax(name):
    """Each processor on the same numpy logits [4, 20], sequences [4, 16]
    (tokens drawn from a 6-id range so n-grams repeat), valid mask and
    bad-words mask, at cur_len 10: within 1e-6 of JAX, and the same banned
    set."""
    rng = np.random.RandomState(sorted(PROCESSORS).index(name))
    logits = rng.standard_normal((4, 20)).astype(np.float32) * 3
    seqs = rng.randint(0, 6, (4, 16)).astype(np.int32)
    valid = (np.arange(16)[None, :] < 10).astype(np.int32).repeat(4, 0)
    valid[0, :3] = 0
    bad = rng.rand(4, 20) < 0.2
    arrays = (logits, seqs, valid, bad)
    want = np.asarray(PROCESSORS[name](J, *map(jnp.asarray, arrays), 10))
    got = PROCESSORS[name](G, *map(torch.from_numpy, arrays), 10).numpy()
    np.testing.assert_array_equal(got <= G.NEG_INF, want <= J.NEG_INF)
    np.testing.assert_allclose(got, want, atol=PROC_ATOL, rtol=1e-6)


@pytest.mark.parametrize("kw", [
    {},
    {"no_repeat_ngram_size": 2, "repetition_penalty": 1.5, "min_length": 9},
], ids=["plain", "processors"])
def test_greedy_is_token_exact_with_jax(tiny, kw):
    jax_model, params, model = tiny
    ids, mask = _prompts(1, [5, 3, 7], 7)
    want = _jax_generate(jax_model, params, ids, mask, 19, pad_token_id=0,
                         **kw)
    got = _torch_generate(model, ids, mask, 19, pad_token_id=0, **kw)
    np.testing.assert_array_equal(got, want)
    # with EOS: pick a token the first row emits mid-way, so rows finish
    # and the pad fill after EOS is compared too
    eos = int(want[0, 10])
    want = _jax_generate(jax_model, params, ids, mask, 19, pad_token_id=0,
                         eos_token_id=eos, **kw)
    got = _torch_generate(model, ids, mask, 19, pad_token_id=0,
                          eos_token_id=eos, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 11:] == 0).all()


def _beam_eos(jax_model, params, ids, mask):
    """A token the greedy run emits early, as EOS: beams then finish."""
    greedy = _jax_generate(jax_model, params, ids, mask, 16, pad_token_id=0)
    return int(greedy[0, ids.shape[1] + 2])


@pytest.mark.parametrize("kw", [
    {"num_beams": 3},
    {"num_beams": 3, "num_return_sequences": 3},
    {"num_beams": 4, "num_return_sequences": 2, "length_penalty": 0.8},
    {"num_beams": 4, "num_beam_groups": 2, "diversity_penalty": 0.7},
    {"num_beams": 3, "no_repeat_ngram_size": 2, "early_stopping": False},
], ids=["beam3", "return3", "return2-lp", "groups", "ngram-late-stop"])
def test_beam_search_is_token_exact_with_jax(tiny, kw):
    jax_model, params, model = tiny
    ids, mask = _prompts(2, [4, 2], 4)
    eos = _beam_eos(jax_model, params, ids, mask)
    common = dict(pad_token_id=0, eos_token_id=eos, **kw)
    want = _jax_generate(jax_model, params, ids, mask, 16, **common)
    got = _torch_generate(model, ids, mask, 16, **common)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got[..., :4] == ids[:, None, :] if got.ndim == 3
            else got[:, :4] == ids).all()


def test_long_prompt_runs_the_flash_twin_and_stays_token_exact(monkeypatch):
    """A ~520-token prompt (n_positions 1024): prefill attends over 520 keys
    and every decode step over 526 cache slots, both past the short
    kernel's 512, so the port takes flash_attention_fwd (its plain twin on
    the CPU) in every layer of every step. Greedy and beam search stay
    token-exact with JAX, whose prefill and decode take its XLA reference
    path (a bias over the cache)."""
    jax_model, params, model = _models(n_positions=1024)
    ids, mask = _prompts(3, [520, 515], 520)
    calls = []
    real = A.flash_attention_fwd_reference

    def spy(q, k, *a, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, *a, **kw)
    monkeypatch.setattr(A, "flash_attention_fwd_reference", spy)

    want = _jax_generate(jax_model, params, ids, mask, 526, pad_token_id=0)
    got = _torch_generate(model, ids, mask, 526, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    # prefill (Sq = Skv = 520) and 5 decode steps (the 6th token's decode is
    # never read), in both layers
    assert calls == [(520, 520)] * 2 + [(1, 526)] * 10
    assert A.flash_attention_fwd.launches == 0  # CPU tensors: the twin

    calls.clear()
    kw = dict(pad_token_id=0, num_beams=2, num_return_sequences=2)
    want = _jax_generate(jax_model, params, ids, mask, 524, **kw)
    got = _torch_generate(model, ids, mask, 524, **kw)
    np.testing.assert_array_equal(got, want)
    assert calls[:2] == [(520, 520)] * 2 and len(calls) == 2 + 2 * 3


def test_sampling_is_deterministic_under_one_generator(tiny):
    """Sampled tokens are a function of the generator's seed; top_k=1
    sampling is greedy; the warped distribution never yields a token the
    processors ban (top_k=3 keeps the 3 best of each step's logits)."""
    _, _, model = tiny
    ids, mask = _prompts(4, [5, 6], 6)

    def run(seed, **kw):
        return _torch_generate(model, ids, mask, 20, pad_token_id=0,
                               do_sample=True,
                               generator=torch.Generator().manual_seed(seed),
                               **kw)

    a, b, c = run(0, temperature=1.5), run(0, temperature=1.5), run(1, temperature=1.5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert (a[:, :6] == ids).all() and (a >= 0).all() and (a < 97).all()
    greedy = _torch_generate(model, ids, mask, 20, pad_token_id=0)
    np.testing.assert_array_equal(run(5, top_k=1), greedy)

    prefill, decode = make_gpt2_generation_fns(model, 20)
    kept = run(2, top_k=3)
    with torch.inference_mode():
        logits, cache = prefill(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
        for step in range(6, 20):
            top3 = torch.topk(logits, 3, dim=-1).indices.numpy()
            assert all(kept[r, step] in top3[r] for r in range(2)), step
            logits, cache = decode(torch.from_numpy(kept[:, step:step + 1])
                                   .long(), cache)


def test_beam_sample_is_deterministic_under_one_generator(tiny):
    _, _, model = tiny
    ids, mask = _prompts(5, [4, 4], 4)

    def run(seed):
        return _torch_generate(model, ids, mask, 14, pad_token_id=0,
                               num_beams=3, do_sample=True, top_k=20,
                               generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert (a[:, :4] == ids).all()


def test_unported_generation_options_raise(tiny):
    _, _, model = tiny
    with pytest.raises(NotImplementedError, match="A16"):
        make_gpt2_generation_fns(model, 16, kv_cache="int8")
    prefill, decode = make_gpt2_generation_fns(model, 16)
    ids, mask = _prompts(6, [3], 3)
    with pytest.raises(NotImplementedError, match="A16"):
        G.generate(prefill, decode, torch.from_numpy(ids).long(),
                   torch.from_numpy(mask), max_length=16,
                   speculative="prompt_lookup")
    for fn in (decode.chunk, decode.rollback):
        with pytest.raises(NotImplementedError, match="A16"):
            fn(None, None)
