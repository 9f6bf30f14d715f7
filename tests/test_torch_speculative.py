"""The port's prompt-lookup speculative decoding (slice 11, A16) against
the JAX package's, on the CPU, f32.

- prompt_lookup_drafts and its rowwise form equal JAX's on random
  histories (ids exactly);
- a verify chunk equals the same tokens decoded one by one (GPT-2 at a
  shared index and per row, BART, T5; logits within 1e-5), and a rollback
  then decodes as if the rejected tokens had never been fed;
- speculative greedy (per-row and batch-shared acceptance) equals the
  port's plain greedy and JAX's speculative output token for token, on
  GPT-2, BART and T5; its stats count one read-back a round plus one;
- sampled speculative decoding with top_k=1 equals greedy, and a seeded
  generator repeats (its stream differs from JAX's: ROADMAP reference
  fault 4);
- generate()'s silent fallbacks (beams, repetition penalty,
  no-repeat-ngram, an adapter without `chunk`) and its cache_slack error;
- DeviceContinuousDecoder(speculative=) covers JAX's
  test_continuous_speculative.py cases: mixed lengths, EOS inside a
  chunk, zero acceptance, the sampling fallback, the window edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.modelzoo import generation_utils as J
from easynlp_tpu.modelzoo import speculative as JS
from easynlp_tpu.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns as jax_fns,
)
from easynlp_tpu.modelzoo.seq2seq_generation import (
    encoder_decoder_generate as jax_s2s_generate,
)
from easynlp_tpu_torch.modelzoo import generation_utils as G
from easynlp_tpu_torch.modelzoo import speculative as S
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)
from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
    encoder_decoder_generate,
    make_encoder_decoder_fns,
)
from easynlp_tpu_torch.serving import continuous as C

from test_torch_generation import _models

ATOL = 1e-5
SPEC = dict(speculative="prompt_lookup", num_draft_tokens=4, ngram_size=2)


@pytest.fixture(scope="module")
def tiny():
    return _models()


def _histories(seed, b=4, t=24):
    """Cyclic and random rows, left-padded, with per-row committed
    lengths."""
    rng = np.random.RandomState(seed)
    seqs = np.zeros((b, t), np.int32)
    valid = np.zeros((b, t), np.int32)
    cur = rng.randint(6, t - 2, b)
    for i in range(b):
        pad = rng.randint(0, 3)
        motif = list(rng.randint(1, 9, rng.randint(2, 5)))
        row = (motif * t)[:cur[i] - pad] if i % 2 == 0 \
            else list(rng.randint(1, 9, cur[i] - pad))
        seqs[i, pad:cur[i]] = row
        valid[i, pad:cur[i]] = 1
    return seqs, valid, cur.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drafts_match_jax(seed):
    seqs, valid, cur = _histories(seed)
    for n, k in ((2, 4), (3, 2), (1, 5)):
        want = np.asarray(JS.prompt_lookup_drafts_rowwise(
            jnp.asarray(seqs), jnp.asarray(valid), jnp.asarray(cur), k, n,
            0))
        got = S.prompt_lookup_drafts_rowwise(
            torch.from_numpy(seqs), torch.from_numpy(valid),
            torch.from_numpy(cur), k, n, 0).numpy()
        np.testing.assert_array_equal(got, want)
        step = int(cur.max())
        want = np.asarray(JS.prompt_lookup_drafts(
            jnp.asarray(seqs), jnp.asarray(valid), jnp.asarray(step), k, n,
            0))
        got = S.prompt_lookup_drafts(torch.from_numpy(seqs),
                                     torch.from_numpy(valid), step, k, n,
                                     0).numpy()
        np.testing.assert_array_equal(got, want)


def _gpt2_chunk_vs_steps(model, rowwise):
    from test_torch_generation import _prompts
    ids, mask = _prompts(3, [5, 8, 3], 8)
    toks = np.random.RandomState(4).randint(1, 96, (3, 4)).astype(np.int32)
    out = []
    for mode in ("steps", "chunk"):
        prefill, decode = make_gpt2_generation_fns(model, 20, cache_slack=5)
        _, cache = prefill(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask))
        if rowwise:
            cache.index = torch.full((3,), cache.index)
        if mode == "chunk":
            fn = decode.chunk_rowwise if rowwise else decode.chunk
            logits, cache = fn(torch.from_numpy(toks).long(), cache)
        else:
            logits = []
            for j in range(4):
                if rowwise:
                    logits.append(decode.chunk_rowwise(
                        torch.from_numpy(toks[:, j:j + 1]).long(),
                        cache)[0][:, 0])
                    cache.index = cache.index + 1
                else:
                    logits.append(decode(torch.from_numpy(
                        toks[:, j:j + 1]).long(), cache)[0])
            logits = torch.stack(logits, 1)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("rowwise", [False, True], ids=["shared", "rowwise"])
def test_gpt2_chunk_equals_sequential_decode(tiny, rowwise):
    with torch.inference_mode():
        steps, chunk = _gpt2_chunk_vs_steps(tiny[2], rowwise)
    np.testing.assert_allclose(chunk, steps, atol=ATOL)


def _s2s_models(family):
    if family == "bart":
        from test_torch_bart import _batch, _models
        jax_model, params, model = _models()
        ids, mask = _batch(2, [9, 5, 7], 9)
        return jax_model, params, model, ids, mask, {}
    from test_torch_t5 import FAMILIES, T5_TINY, JaxT5, jax_params
    from test_torch_t5 import _batch, port_model
    port_cls, jax_cls, extra = FAMILIES["t5"]
    model = port_model(port_cls(**T5_TINY, **extra))
    jax_cfg = jax_cls(**T5_TINY, **extra)
    ids, mask = _batch(4, [11, 6, 9], 11)
    banned = np.zeros(120, bool)
    banned[0] = True
    return (JaxT5.from_config(jax_cfg, dtype=jnp.float32),
            jax_params(model, jax_cfg), model, ids, mask,
            {"bad_words_mask": banned})


@pytest.mark.parametrize("family", ["bart", "t5"])
def test_seq2seq_chunk_rollback_and_generate_match_jax(family):
    """The decoder's verify chunk equals single steps, a rollback of 2
    decodes as if they were never fed, and speculative generation equals
    plain greedy and JAX's speculative output."""
    jax_model, params, model, ids, mask, kw = _s2s_models(family)
    src, smask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        3, 100, (3, 4))).long()
    start = torch.full((3, 1), model.config.decoder_start_token_id)
    with torch.inference_mode():
        runs = []
        for mode in ("steps", "chunk"):
            prefill, decode = make_encoder_decoder_fns(model, 12, src, smask,
                                                       cache_slack=5)
            _, state = prefill(start, torch.ones((3, 1), dtype=torch.int32))
            if mode == "chunk":
                logits, state = decode.chunk(toks, state)
                state = decode.rollback(state, 2)
            else:
                logits = [decode(toks[:, j:j + 1], state)[0]
                          for j in range(4)]
                logits = torch.stack(logits, 1)
                state["cache"].index -= 2
            after, _ = decode(toks[:, 2:3], state)
            runs.append((logits.numpy(), after.numpy()))
        np.testing.assert_allclose(runs[1][0], runs[0][0], atol=ATOL)
        np.testing.assert_allclose(runs[1][1], runs[0][1], atol=ATOL)
        pkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        got = encoder_decoder_generate(model, src, smask, max_length=16,
                                       **SPEC, **pkw).numpy()
        plain = encoder_decoder_generate(model, src, smask, max_length=16,
                                         **pkw).numpy()
    want = np.asarray(jax_s2s_generate(
        jax_model, params, jnp.asarray(ids), jnp.asarray(mask),
        max_length=16, **SPEC, **{k: jnp.asarray(v) for k, v in
                                  kw.items()}))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def _repetitive(seed, n=4, width=12):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        motif = list(rng.randint(1, 96, 3))
        rows.append((motif * 5)[:rng.randint(5, width + 1)] if i % 2 == 0
                    else list(rng.randint(1, 96, rng.randint(3, width))))
    return G.left_pad(rows, 0, length=width)


@pytest.mark.parametrize("rowwise", [True, False], ids=["rowwise", "shared"])
def test_gpt2_speculative_matches_greedy_and_jax(tiny, rowwise):
    jax_model, params, model = tiny
    ids, mask = _repetitive(6)
    t, eos = 36, 7
    prefill, decode = make_gpt2_generation_fns(model, t, cache_slack=5)
    if not rowwise:
        del decode.chunk_rowwise
    with torch.inference_mode():
        got = G.generate(prefill, decode, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), max_length=t,
                         eos_token_id=eos, **SPEC).numpy()
        plain = G.generate(*make_gpt2_generation_fns(model, t),
                           torch.from_numpy(ids).long(),
                           torch.from_numpy(mask), max_length=t,
                           eos_token_id=eos).numpy()
    jp, jd = jax_fns(jax_model, t, cache_slack=5)
    if not rowwise:
        del jd.chunk_rowwise
    want = np.asarray(J.generate(jp, jd, params, jnp.asarray(ids),
                                 jnp.asarray(mask), max_length=t,
                                 eos_token_id=eos, **SPEC))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("rowwise", [True, False], ids=["rowwise", "shared"])
def test_stats_count_one_read_back_a_round(tiny, rowwise):
    _, _, model = tiny
    ids, mask = _repetitive(7)
    prefill, decode = make_gpt2_generation_fns(model, 30, cache_slack=5)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask), 30)
    with torch.inference_mode():
        if rowwise:
            _, _, stats = S.speculative_greedy_rowwise(
                prefill, decode.chunk_rowwise, *args, num_draft_tokens=4)
        else:
            _, _, stats = S.speculative_greedy(
                prefill, decode.chunk, decode.rollback, *args,
                num_draft_tokens=4)
    assert stats["read_backs"] == stats["verify_rounds"] + 1
    assert stats["accepted_drafts"] > 0  # the cyclic rows accept drafts
    assert stats["verify_rounds"] < stats["generated"]


def test_sampled_speculative_top_k_1_is_greedy_and_seeded(tiny):
    _, _, model = tiny
    ids, mask = _repetitive(8)
    a = [torch.from_numpy(ids).long(), torch.from_numpy(mask)]
    with torch.inference_mode():
        greedy = G.generate(*make_gpt2_generation_fns(model, 28), *a,
                            max_length=28).numpy()
        runs = []
        for top_k, seed in ((1, 0), (0, 3), (0, 3), (0, 4)):
            prefill, decode = make_gpt2_generation_fns(model, 28,
                                                       cache_slack=5)
            runs.append(G.generate(
                prefill, decode, *a, max_length=28, do_sample=True,
                top_k=top_k, temperature=1.5,
                generator=torch.Generator().manual_seed(seed),
                **SPEC).numpy())
    np.testing.assert_array_equal(runs[0], greedy)
    np.testing.assert_array_equal(runs[1], runs[2])
    assert not np.array_equal(runs[1], runs[3])


@pytest.mark.parametrize("kw", [{"num_beams": 2},
                                {"repetition_penalty": 1.3},
                                {"no_repeat_ngram_size": 2}, "no_chunk"],
                         ids=["beams", "repetition", "ngram", "no-chunk"])
def test_generate_falls_back_as_jax_does(tiny, kw):
    """Under beams, a content processor or an adapter without `chunk`,
    speculative= is ignored: the plain loop's tokens."""
    _, _, model = tiny
    ids, mask = _repetitive(9)
    a = [torch.from_numpy(ids).long(), torch.from_numpy(mask)]
    extra = {} if kw == "no_chunk" else kw
    with torch.inference_mode():
        plain = G.generate(*make_gpt2_generation_fns(model, 24), *a,
                           max_length=24, **extra).numpy()
        prefill, decode = make_gpt2_generation_fns(model, 24)
        if kw == "no_chunk":
            del decode.chunk
        got = G.generate(prefill, decode, *a, max_length=24, **extra,
                         **SPEC).numpy()
    np.testing.assert_array_equal(got, plain)


def test_cache_slack_is_checked(tiny):
    _, _, model = tiny
    ids, mask = _repetitive(10)
    prefill, decode = make_gpt2_generation_fns(model, 24, cache_slack=4)
    with pytest.raises(ValueError, match="cache_slack=5"):
        G.generate(prefill, decode, torch.from_numpy(ids).long(),
                   torch.from_numpy(mask), max_length=24, **SPEC)
    with pytest.raises(ValueError, match="repetition_penalty"):
        S.speculative_greedy(prefill, decode.chunk, decode.rollback,
                             torch.from_numpy(ids).long(),
                             torch.from_numpy(mask), 24,
                             repetition_penalty=1.2)


# -- the device decoder (JAX's test_continuous_speculative.py) ----------------

def _decoders(model, spec=(2, 4), eos=None, max_length=64):
    plain = C.DeviceContinuousDecoder(model, max_slots=2,
                                      max_length=max_length,
                                      prompt_bucket=16, eos_token_id=eos,
                                      chunk_size=4)
    fast = C.DeviceContinuousDecoder(model, max_slots=2,
                                     max_length=max_length,
                                     prompt_bucket=16, eos_token_id=eos,
                                     speculative=spec)
    return plain, fast


def _repetitive_prompts(n, rng):
    prompts = []
    for i in range(n):
        if i % 3 == 2:
            prompts.append(rng.randint(1, 96, rng.randint(4, 10)).tolist())
        else:
            motif = rng.randint(1, 96, 3).tolist()
            prompts.append((motif * 4)[:rng.randint(8, 13)])
    return prompts


def test_device_decoder_mixed_lengths(tiny):
    plain, fast = _decoders(tiny[2])
    prompts = _repetitive_prompts(7, np.random.RandomState(0))
    budgets = [17, 5, 23, 1, 9, 30, 12]
    want = plain(prompts, max_new_tokens=budgets)
    assert fast(prompts, max_new_tokens=budgets) == want
    stats = fast.last_spec_stats
    assert stats["tokens_committed_in_rounds"] > stats["verify_rounds"] >= 1
    assert stats["read_backs"] >= stats["verify_rounds"]


def test_device_decoder_eos_inside_a_chunk(tiny):
    rng = np.random.RandomState(1)
    prompts = _repetitive_prompts(4, rng)
    base = _decoders(tiny[2])[0](prompts, max_new_tokens=20)
    eos = base[0][len(base[0]) // 2]
    plain, fast = _decoders(tiny[2], eos=eos)
    want = plain(prompts, max_new_tokens=20)
    assert fast(prompts, max_new_tokens=20) == want
    assert any(o and o[-1] == eos for o in want)


def test_device_decoder_zero_acceptance(tiny):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 96, rng.randint(3, 9)).tolist()
               for _ in range(4)]
    plain, fast = _decoders(tiny[2])
    assert fast(prompts, max_new_tokens=10) == plain(prompts,
                                                     max_new_tokens=10)


def test_device_decoder_sampling_falls_back(tiny):
    prompts = _repetitive_prompts(3, np.random.RandomState(5))
    plain, fast = _decoders(tiny[2])
    kw = dict(max_new_tokens=8, do_sample=[False, True, False],
              temperature=0.8, seed=[0, 7, 0])
    assert fast(prompts, **kw) == plain(prompts, **kw)
    assert fast.last_spec_stats is None


def test_device_decoder_window_edge(tiny):
    """The constructor refuses a bucket too close to the window for K+1
    verify entries; at the edge that fits, slots retire K entries early,
    token-exact with the plain decoder's shorter outputs."""
    with pytest.raises(ValueError, match="K\\+1"):
        C.DeviceContinuousDecoder(tiny[2], max_slots=2, max_length=20,
                                  prompt_bucket=16, speculative=(2, 4))
    plain, fast = _decoders(tiny[2], max_length=24)
    prompts = _repetitive_prompts(3, np.random.RandomState(6))
    got = fast(prompts, max_new_tokens=12)
    want = plain(prompts, max_new_tokens=12)
    for g, w in zip(got, want):
        assert g == w[:len(g)] and len(g) >= 1
