"""The port's continuous batching (easynlp_tpu_torch/serving/continuous.py)
against the JAX package's.

One tiny GPT-2 (2 layers, n_embd 32, vocab 97), initialised by the JAX
package and carried into the port with state_dict_from_jax; a 32-slot KV
window, prompts bucketed to 16, 2-3 decode slots. Both run in f32 on the
CPU (the port's attention through its kernels' plain twins). Bounds:
logits of the per-slot and offset cache paths within 1e-5 of JAX's
module.apply; greedy outputs of both batchers, both device decoders and
standalone greedy decoding token-exact; the warped logits of
rowwise_warp_and_sample within 1e-6 of JAX's scalar warps. Sampled tokens
are not compared across the packages (their random streams differ, ROADMAP
C4): within the port they must not depend on co-tenants, slots or chunk
size, and their frequencies must pass a chi-square test against
softmax(warped) at p = 0.001.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easynlp_tpu.modelzoo.generation_utils import (
    apply_temperature,
    apply_top_k,
    apply_top_p,
)
from easynlp_tpu.modelzoo.generation_utils import (
    rowwise_warp_and_sample as jax_rowwise,
)
from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config as JaxGPT2Config
from easynlp_tpu.modelzoo.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from easynlp_tpu.serving import continuous as jax_continuous
from easynlp_tpu_torch.modelzoo import generation_utils as G
from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Config, GPT2LMHeadModel
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import KVCache
from easynlp_tpu_torch.serving import continuous as C

TINY = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=2,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
WINDOW, BUCKET = 32, 16
LOGITS_ATOL = 1e-5
WARP_ATOL = 1e-6
CHI2_P = 1e-3
# mixed lengths; budgets that retire early, refill the 2 slots, and one
# (20) past the window: it stops where the cache ends (index 31)
PROMPTS = [[5, 6, 7, 5, 6, 7], [11, 23, 42], [9, 10], [50, 60, 70, 80],
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(20, 36))]
BUDGETS = [10, 7, 12, 5, 20, 9]
PREFIX = [7, 8, 9, 10, 11]
SAMPLING = [{}, dict(do_sample=True, temperature=1.3, seed=11),
            dict(do_sample=True, top_k=5, seed=2),
            dict(do_sample=True, top_p=0.8, temperature=0.9, seed=33),
            dict(do_sample=True, temperature=2.0, top_k=20, top_p=0.95,
                 seed=4), {}]


@pytest.fixture(scope="module")
def models():
    jax_model = JaxGPT2.from_config(JaxGPT2Config(**TINY), dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = nn.unbox(jax_model.init(
        {"params": rng, "dropout": rng}, input_ids=jnp.ones((1, 4), jnp.int32),
        deterministic=True)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    config = GPT2Config(**TINY)
    model = GPT2LMHeadModel(config).eval()
    model.transformer.load_state_dict(state_dict_from_jax(params, config),
                                      strict=True)
    return jax_model, params, model


def standalone_greedy(model, prompt, n_new, eos=None, prefix=()):
    """The port's plain greedy decode of prefix + prompt, left-padded to
    len(prefix) + BUCKET (as the batcher pads), EOS included."""
    p = len(prefix) + BUCKET
    ids, mask = G.left_pad([list(prefix) + list(prompt)], 0, length=p)
    prefill, decode = make_gpt2_generation_fns(model, p + n_new)
    with torch.no_grad():
        seqs, valid = G.greedy_or_sample(
            prefill, decode, torch.from_numpy(ids).long(),
            torch.from_numpy(mask), p + n_new, pad_token_id=0,
            eos_token_id=eos)
    return [int(t) for t, v in zip(seqs[0, p:], valid[0, p:]) if v]


@pytest.fixture(scope="module")
def eos(models):
    """A token the model emits for one of the prompts, so EOS retires some
    requests mid-flight."""
    return standalone_greedy(models[2], PROMPTS[0], 6)[3]


def _submit_all(batcher, prompts, budgets, kwargs=None):
    kwargs = kwargs or [{}] * len(prompts)
    handles = [batcher.submit(p, max_new_tokens=n, **kw)
               for p, n, kw in zip(prompts, budgets, kwargs)]
    return [h.result(timeout=300) for h in handles]


@pytest.fixture(scope="module")
def jax_greedy(models, eos):
    """JAX ContinuousBatcher's greedy outputs for PROMPTS (2 slots)."""
    jax_model, params, _ = models
    b = jax_continuous.ContinuousBatcher(
        jax_model, params, max_slots=2, max_length=WINDOW,
        prompt_buckets=(BUCKET,), eos_token_id=eos, pad_token_id=0,
        chunk_size=3)
    try:
        return _submit_all(b, PROMPTS, BUDGETS)
    finally:
        b.stop()


def _random_cache(rng, b, t, lengths, index):
    """[L] lists of k/v [B,T,H,D] and a [B,T] mask: row i holds real tokens
    on [index_i - lengths_i, index_i)."""
    c = GPT2Config(**TINY)
    shape = (c.n_layer, b, t, c.n_head, c.n_embd // c.n_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    mask = np.zeros((b, t), np.int32)
    for row, (n, i) in enumerate(zip(lengths, np.broadcast_to(index, b))):
        mask[row, i - n:i] = 1
    return k, v, mask


def test_per_slot_decode_step_matches_jax(models):
    """One decode step with a per-row write index ([B] tensor): the JAX
    model's scatter path (its continuous batching) and the port's, logits
    within 1e-5 and the same cache rows written."""
    jax_model, params, model = models
    rng = np.random.RandomState(0)
    b, t = 3, WINDOW
    index = np.array([5, 17, 30], np.int32)
    k, v, mask = _random_cache(rng, b, t, [5, 9, 30], index)
    mask[np.arange(b), index] = 1  # the new token's slot, marked first
    tokens = rng.randint(1, 97, (b, 1)).astype(np.int32)
    positions = (mask.sum(-1, keepdims=True) - 1).astype(np.int32)
    out = jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(tokens),
        position_ids=jnp.asarray(positions),
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "mask": jnp.asarray(mask), "index": jnp.asarray(index)},
        deterministic=True)
    cache = KVCache([torch.from_numpy(x.copy()) for x in k],
                    [torch.from_numpy(x.copy()) for x in v],
                    torch.from_numpy(mask), torch.from_numpy(index).long())
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(),
                    position_ids=torch.from_numpy(positions).long(),
                    cache=cache)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(out["logits"]), atol=LOGITS_ATOL)
    want_k = np.asarray(out["cache"]["k"])
    for layer in range(len(k)):
        np.testing.assert_allclose(cache.k[layer].numpy(), want_k[layer],
                                   atol=LOGITS_ATOL)
    torch.testing.assert_close(got["cache"].index,
                               torch.from_numpy(index).long() + 1)


def test_offset_chunk_matches_jax(monkeypatch, models):
    """A chunk of s = 5 tokens written at cache index 6 (the shared-prefix
    admit), one row left-padded inside the chunk: JAX attends over all T
    slots under a causal bias, the port causally over the first 6 + 5 slots
    through the short kernel's twin (never attention_reference, which a
    bias would force). Logits within 1e-5."""
    from easynlp_tpu_torch.ops import attention as A
    jax_model, params, model = models
    rng = np.random.RandomState(1)
    b, t, index, s = 2, 24, 6, 5
    k, v, mask = _random_cache(rng, b, t, [6, 6], index)
    chunk_mask = np.ones((b, s), np.int32)
    chunk_mask[1, :2] = 0
    mask[:, index:index + s] = chunk_mask
    tokens = rng.randint(1, 97, (b, s)).astype(np.int32)
    positions = (index + np.maximum(np.cumsum(chunk_mask, -1) - 1, 0)
                 ).astype(np.int32)
    out = jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(tokens),
        attention_mask=jnp.asarray(chunk_mask),
        position_ids=jnp.asarray(positions),
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "mask": jnp.asarray(mask),
               "index": jnp.asarray(index, jnp.int32)},
        deterministic=True)
    calls = []
    real = A.short_attention_fwd_reference

    def spy(q, k_, v_, kv_mask, causal=False, scale=None):
        calls.append((q.shape[1], k_.shape[1], causal))
        return real(q, k_, v_, kv_mask, causal, scale)
    monkeypatch.setattr(A, "short_attention_fwd_reference", spy)
    monkeypatch.setattr(A, "attention_reference", None)  # must not be hit
    cache = KVCache([torch.from_numpy(x.copy()) for x in k],
                    [torch.from_numpy(x.copy()) for x in v],
                    torch.from_numpy(mask), index)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(),
                    attention_mask=torch.from_numpy(chunk_mask),
                    position_ids=torch.from_numpy(positions).long(),
                    cache=cache)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(out["logits"]), atol=LOGITS_ATOL)
    assert calls == [(s, index + s, True)] * 2
    assert got["cache"].index == index + s


def test_per_slot_chunk_keeps_raising(models):
    """A per-slot index with a chunk of s = 4 tokens (a speculative verify
    round, which raised until slice 11 ported it): each row's tokens land
    at its own index under JAX's per-row causal bias; logits and written
    cache rows within 1e-5 of the JAX model's scatter path. The int8 cache
    takes a shared index only and raises here, as JAX's cannot take one."""
    jax_model, params, model = models
    rng = np.random.RandomState(2)
    b, t, s = 3, WINDOW, 4
    index = np.array([5, 17, 26], np.int32)
    k, v, mask = _random_cache(rng, b, t, [5, 9, 26], index)
    positions = (mask.sum(-1, keepdims=True) + np.arange(s)).astype(np.int32)
    mask[np.arange(b)[:, None], index[:, None] + np.arange(s)] = 1
    tokens = rng.randint(1, 97, (b, s)).astype(np.int32)
    out = jax_model.apply(
        {"params": params}, input_ids=jnp.asarray(tokens),
        position_ids=jnp.asarray(positions),
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "mask": jnp.asarray(mask), "index": jnp.asarray(index)},
        deterministic=True)
    cache = KVCache([torch.from_numpy(x.copy()) for x in k],
                    [torch.from_numpy(x.copy()) for x in v],
                    torch.from_numpy(mask), torch.from_numpy(index).long())
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(),
                    position_ids=torch.from_numpy(positions).long(),
                    cache=cache)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(out["logits"]), atol=LOGITS_ATOL)
    want_k = np.asarray(out["cache"]["k"])
    for layer in range(len(k)):
        np.testing.assert_allclose(cache.k[layer].numpy(), want_k[layer],
                                   atol=LOGITS_ATOL)
    int8 = model.init_cache(2, 16, quantize=True)
    int8.index = torch.tensor([3, 5])
    with pytest.raises(ValueError, match="shared write index"), \
            torch.no_grad():
        model(torch.ones((2, 3), dtype=torch.long), cache=int8)


def test_batcher_greedy_matches_jax_and_standalone(models, eos, jax_greedy):
    """Mixed prompt lengths and budgets through 2 slots (each reused), EOS
    from the model's own output, one request stopped by the window's end:
    the port's ContinuousBatcher gives JAX's tokens and standalone greedy
    decoding's, with EOS included."""
    model = models[2]
    b = C.ContinuousBatcher(model, max_slots=2, max_length=WINDOW,
                            prompt_buckets=(BUCKET,), eos_token_id=eos,
                            pad_token_id=0, chunk_size=3)
    try:
        got = _submit_all(b, PROMPTS, BUDGETS)
    finally:
        b.stop()
    assert got == jax_greedy
    assert any(out[-1] == eos and len(out) < n
               for out, n in zip(got, BUDGETS))  # EOS retired one early
    assert len(got[4]) == WINDOW - 1 - BUCKET < BUDGETS[4]  # window end
    for prompt, n, out in zip(PROMPTS, BUDGETS, got):
        assert out == standalone_greedy(model, prompt, n, eos)[:len(out)]


def test_device_decoder_matches_jax_and_batcher(models, jax_greedy, eos):
    """The port's DeviceContinuousDecoder: greedy outputs equal JAX's
    DeviceContinuousDecoder's, and the batcher's up to the window's end
    (both JAX decoders, and so both of the port's, differ there: the device
    decoder fills the window's last slot, the thread batcher stops one slot
    short, unless it is built with fill_window=True, which gives the
    device decoder's tokens); sampled outputs equal the port batcher's for
    the same (prompt, seed), with other slot counts and chunk sizes."""
    jax_model, params, model = models
    jax_dec = jax_continuous.DeviceContinuousDecoder(
        jax_model, params, max_slots=3, max_length=WINDOW,
        prompt_bucket=BUCKET, eos_token_id=eos, pad_token_id=0,
        chunk_size=4)
    want = jax_dec(PROMPTS, BUDGETS)
    dec = C.DeviceContinuousDecoder(model, max_slots=3, max_length=WINDOW,
                                    prompt_bucket=BUCKET, eos_token_id=eos,
                                    pad_token_id=0, chunk_size=4)
    got = dec(PROMPTS, BUDGETS)
    assert got == want
    assert [o[:len(b)] for o, b in zip(got, jax_greedy)] == jax_greedy
    assert [len(o) - len(b) for o, b in zip(got, jax_greedy)] == \
        [0, 0, 0, 0, 1, 0]  # request 4 reaches the window's end
    filled = C.ContinuousBatcher(model, max_slots=2, max_length=WINDOW,
                                 prompt_buckets=(BUCKET,), eos_token_id=eos,
                                 pad_token_id=0, chunk_size=3,
                                 fill_window=True)
    try:
        assert _submit_all(filled, PROMPTS, BUDGETS) == want
    finally:
        filled.stop()
    kw = {key: [s.get(key, d) for s in SAMPLING] for key, d in (
        ("do_sample", False), ("temperature", 1.0), ("top_k", 0),
        ("top_p", 1.0), ("seed", 0))}
    sampled = dec(PROMPTS, BUDGETS, **kw)
    b = C.ContinuousBatcher(model, max_slots=2, max_length=WINDOW,
                            prompt_buckets=(BUCKET,), eos_token_id=eos,
                            pad_token_id=0, chunk_size=5)
    try:
        batched = _submit_all(b, PROMPTS, BUDGETS, SAMPLING)
    finally:
        b.stop()
    assert [o[:len(b)] for o, b in zip(sampled, batched)] == batched
    assert sampled[0] == want[0] and sampled[5] == want[5]  # greedy rows
    assert dec([[1, 2]], 0) == [[]]
    with pytest.raises(ValueError, match="prompt_bucket"):
        dec([list(range(1, 18))], 3)


def test_shared_prefix_matches_full_prompt_and_jax(models):
    """A batcher-wide shared prefix (its KV prefilled once, suffixes
    admitted at offset 5): token-exact with the same requests sent as
    prefix + suffix to a prefix-less batcher, with standalone greedy
    decoding of prefix + suffix, and with JAX's DeviceContinuousDecoder
    under the same prefix."""
    jax_model, params, model = models
    suffixes = [p[:8] for p in PROMPTS[:5]]
    budgets = [6, 9, 4, 8, 7]
    b = C.ContinuousBatcher(model, max_slots=2, max_length=WINDOW,
                            prompt_buckets=(8,), pad_token_id=0,
                            chunk_size=3, shared_prefix=PREFIX)
    full = C.ContinuousBatcher(model, max_slots=3, max_length=WINDOW,
                               prompt_buckets=(13,), pad_token_id=0,
                               chunk_size=4)
    try:
        got = _submit_all(b, suffixes, budgets)
        whole = _submit_all(full, [PREFIX + s for s in suffixes], budgets)
    finally:
        b.stop()
        full.stop()
    jax_dec = jax_continuous.DeviceContinuousDecoder(
        jax_model, params, max_slots=2, max_length=WINDOW, prompt_bucket=8,
        pad_token_id=0, chunk_size=3, shared_prefix=PREFIX)
    assert got == whole == jax_dec(suffixes, budgets)
    dec = C.DeviceContinuousDecoder(model, max_slots=2, max_length=WINDOW,
                                    prompt_bucket=8, pad_token_id=0,
                                    chunk_size=3, shared_prefix=PREFIX)
    assert dec(suffixes, budgets) == got
    with pytest.raises(ValueError, match="suffix"):
        dec([[]], 4)


def test_rowwise_warp_matches_jax():
    """Per-row temperature, top-k and top-p: the port's warped logits within
    1e-6 of the JAX package's scalar warps (which its rowwise sampler equals,
    tests/test_continuous_sampling.py), and greedy rows, like top_k=1 rows,
    give JAX's rowwise sampler's token."""
    rng = np.random.RandomState(7)
    logits = rng.randn(6, 50).astype(np.float32) * 3
    temps = [1.0, 0.7, 1.3, 0.5, 2.0, 0.9]
    ks = [0, 5, 1, 50, 3, 17]
    ps = [1.0, 0.9, 0.5, 0.3, 1.0, 0.8]
    got = G.rowwise_warp(torch.from_numpy(logits), torch.tensor(temps),
                         torch.tensor(ks), torch.tensor(ps)).numpy()
    for i in range(6):
        want = apply_top_p(apply_top_k(apply_temperature(
            jnp.asarray(logits[i:i + 1]), temps[i]), ks[i]), ps[i])
        np.testing.assert_allclose(got[i], np.asarray(want)[0],
                                   atol=WARP_ATOL, rtol=0)
    ds = [False, True, False, True, True, False]
    ks1 = [0, 1, 0, 1, 1, 0]
    args = (ds, temps, ks1, ps, list(range(6)), [3] * 6)
    want = np.asarray(jax_rowwise(
        jnp.asarray(logits), *(jnp.asarray(a, dt) for a, dt in zip(
            args, (bool, jnp.float32, jnp.int32, jnp.float32, jnp.uint32,
                   jnp.int32)))))
    got = G.rowwise_warp_and_sample(
        torch.from_numpy(logits), *(torch.tensor(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_tokens_follow_softmax_and_ignore_cotenants():
    """4000 draws from one row (positions 0..3999 of one seed) over a
    vocabulary of 8, warped by temperature 0.8, top-k 6 and top-p 0.95:
    cut tokens never drawn, and the kept ones' counts pass a chi-square test
    against softmax(warped) at p = 0.001. The same (seed, position) gives
    the same token whatever rows share the batch."""
    from scipy.stats import chi2
    n = 4000
    row = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0])
    logits = row.repeat(n, 1)
    par = (torch.full((n,), 0.8), torch.full((n,), 6, dtype=torch.long),
           torch.full((n,), 0.95))
    warped = G.rowwise_warp(logits[:1], *(p[:1] for p in par))[0]
    toks = G.rowwise_warp_and_sample(
        logits, torch.ones(n, dtype=torch.bool), *par,
        torch.full((n,), 1234), torch.arange(n))
    counts = np.bincount(toks.numpy(), minlength=8)
    kept = (warped > G.NEG_INF / 2).numpy()
    assert 2 <= kept.sum() < 8 and counts[~kept].sum() == 0
    expect = n * torch.softmax(warped, -1).numpy()[kept]
    stat = (((counts[kept] - expect) ** 2) / expect).sum()
    assert stat < chi2.ppf(1 - CHI2_P, kept.sum() - 1), (counts, expect)
    # row 5's draw with 3 other rows around it, and alone
    rng = torch.Generator().manual_seed(0)
    batch = torch.randn(4, 8, generator=rng)
    batch[1] = row
    sub = (torch.ones(4, dtype=torch.bool), torch.full((4,), 1.0),
           torch.zeros(4, dtype=torch.long), torch.ones(4))
    for pos in range(20):
        together = G.rowwise_warp_and_sample(
            batch, *sub, torch.tensor([9, 1234, 3, 4]),
            torch.tensor([0, pos, 7, 1]))[1]
        alone = G.rowwise_warp_and_sample(
            row[None], *(s[:1] for s in sub), torch.tensor([1234]),
            torch.tensor([pos]))[0]
        assert together == alone


def test_batcher_sampling_ignores_cotenants_and_chunks(models):
    """The same (prompt, seed) twice, beside different co-tenants in other
    slots and with another chunk size: identical tokens; another seed gives
    other tokens."""
    model = models[2]
    kw = dict(do_sample=True, temperature=1.5)
    outs = []
    for chunk, other in ((3, [9, 10, 9, 10]), (5, [5, 6, 7])):
        b = C.ContinuousBatcher(model, max_slots=2, max_length=WINDOW,
                                prompt_buckets=(BUCKET,), pad_token_id=0,
                                chunk_size=chunk)
        try:
            h_other = b.submit(other, max_new_tokens=4)
            h = b.submit([11, 23, 42], max_new_tokens=10, seed=7, **kw)
            outs.append(h.result(timeout=300))
            h_other.result(timeout=300)
            if chunk == 3:
                h8 = b.submit([11, 23, 42], max_new_tokens=10, seed=8, **kw)
                assert h8.result(timeout=300) != outs[0]
        finally:
            b.stop()
    assert outs[0] == outs[1] and len(outs[0]) == 10


class _RacingEvent(threading.Event):
    """An Event whose first is_set() starts close() on another thread and
    waits up to 0.5 s for it: the interleaving of ROADMAP C6 (a close
    landing between push()'s resolved-check and its append)."""

    def __init__(self, req):
        super().__init__()
        self.req, self.armed, self.closer = req, True, None

    def is_set(self):
        state = super().is_set()
        if self.armed:
            self.armed = False
            self.closer = threading.Thread(target=self.req.close)
            self.closer.start()
            self.closer.join(timeout=0.5)
        return state


def _race_push(pending_cls, end):
    req = pending_cls([1], 4, stream=True)
    req.event = _RacingEvent(req)
    req.push(42)
    req.event.closer.join(timeout=10)
    items = []
    while not req.stream_q.empty():
        items.append(req.stream_q.get_nowait())
    return req.tokens, [("END" if x is end else x) for x in items]


def test_push_is_atomic_with_close_unlike_jax():
    """ROADMAP C6: JAX's _Pending.push tests event.is_set() outside
    _close_lock, so a close() in between lets the token land after the
    stream's end (and after result() returned). The port checks and appends
    under the lock: the token is committed, then the stream ends."""
    _, jax_items = _race_push(jax_continuous._Pending,
                              jax_continuous._STREAM_END)
    assert jax_items == ["END", 42]  # the reference fault, pinned
    tokens, items = _race_push(C._Pending, C._STREAM_END)
    assert items == [42, "END"] and tokens == [42]


def test_scheduler_failure_and_cancel(models, monkeypatch):
    """A failing decode chunk kills the scheduler: every pending request
    fails with RuntimeError and a later submit fails at once; a queued
    request cancelled before admission resolves empty."""
    model = models[2]
    b = C.ContinuousBatcher(model, max_slots=1, max_length=WINDOW,
                            prompt_buckets=(BUCKET,), pad_token_id=0,
                            chunk_size=2, start=False)
    queued = b.submit([1, 2], max_new_tokens=3)
    queued.cancel()
    assert queued.result(timeout=1) == []

    def boom(*a, **kw):
        raise MemoryError("device gone")
    monkeypatch.setattr(b, "_decode_chunk", boom)
    b._thread = threading.Thread(target=b._run, daemon=True)
    b._thread.start()
    h = b.submit([1, 2, 3], max_new_tokens=5)
    with pytest.raises(RuntimeError, match="generation failed"):
        h.result(timeout=60)
    with pytest.raises(RuntimeError):
        b.submit([4], max_new_tokens=2).result(timeout=1)
    b.stop()


def test_many_client_threads_with_cancels(models):
    """32 client threads (more than the cores) with a 1 us switch interval
    submit 64 requests to 2 slots and cancel every fifth: every handle
    resolves, and every request not cancelled gets the tokens the same
    request gets alone (a lost update in the shared queue, the slots or a
    handle would break one of the two)."""
    import sys
    model = models[2]
    rng = np.random.RandomState(9)
    work = [(rng.randint(1, 97, rng.randint(2, 9)).tolist(),
             int(rng.randint(1, 5))) for _ in range(64)]
    b = C.ContinuousBatcher(model, max_slots=2, max_length=WINDOW,
                            prompt_buckets=(8,), pad_token_id=0,
                            chunk_size=2)
    got = [None] * len(work)

    def client(i):
        for j in (i, i + 32):
            h = b.submit(work[j][0], max_new_tokens=work[j][1])
            if j % 5 == 0:
                h.cancel()
            got[j] = (j % 5 == 0, h.result(timeout=120))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        alone = [b.submit(p, max_new_tokens=n).result(timeout=120)
                 for p, n in work]
    finally:
        b.stop()
    for (cancelled, out), want in zip(got, alone):
        assert out == (want[:len(out)] if cancelled else want)


def test_speculative_decoder_raises(models, eos):
    """DeviceContinuousDecoder(speculative=(2, 3)), which raised until
    slice 11 ported it: PROMPTS through 2 slots give JAX's speculative
    device decoder's outputs, and the plain device decoder's up to where
    either retires at its window end; a bucket that
    leaves no room for the K+1 verify entries is refused."""
    jax_model, params, model = models
    dec = C.DeviceContinuousDecoder(model, max_slots=2, max_length=WINDOW,
                                    prompt_bucket=BUCKET, eos_token_id=eos,
                                    speculative=(2, 3))
    got = dec(PROMPTS, max_new_tokens=BUDGETS)
    want = jax_continuous.DeviceContinuousDecoder(
        jax_model, params, max_slots=2, max_length=WINDOW,
        prompt_bucket=BUCKET, eos_token_id=eos, speculative=(2, 3))(
        PROMPTS, max_new_tokens=BUDGETS)
    assert got == want
    plain = C.DeviceContinuousDecoder(model, max_slots=2, max_length=WINDOW,
                                      prompt_bucket=BUCKET, eos_token_id=eos,
                                      chunk_size=3)(PROMPTS,
                                                    max_new_tokens=BUDGETS)
    for g, w in zip(got, plain):  # the two retire at different window ends
        n = min(len(g), len(w))
        assert n >= 1 and g[:n] == w[:n]
    assert dec.last_spec_stats["verify_rounds"] >= 1
    with pytest.raises(ValueError, match="K\\+1"):
        C.DeviceContinuousDecoder(model, max_slots=2, max_length=WINDOW,
                                  prompt_bucket=WINDOW - 4,
                                  speculative=(2, 3))
