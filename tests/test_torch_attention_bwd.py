"""The PyTorch port's attention gradients against the JAX package's.

Inputs and the output gradient dO are made with numpy from a seed and handed
to both packages. The port runs on CPU tensors, so the ShortAttention
autograd.Function takes the plain twins of its two CUDA kernels
(short_attention_fwd_reference, short_attention_bwd_reference). JAX runs on
the CPU: jax.grad of attention_reference, and jax.grad of impl='short' in
Pallas interpret mode, as tests/test_attention.py runs it.

f32 bounds: 2e-5 against jax.grad(attention_reference) (the same f32
einsums summed in another order; the gradients here are below 20 in
magnitude, so 2e-5 is about 1e-6 relative). 5e-4 against JAX's short
kernel, the bound tests/test_attention.py holds that kernel's gradients to.
The bf16 tensor-core routes' bound, which the card check uses, is pinned
here against an emulation of their rounding points and against autograd
through bf16 attention_reference.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from easynlp_tpu.ops import attention as jax_attn
from easynlp_tpu_torch.ops import attention as A

ATOL = 2e-5
ATOL_SHORT = 5e-4

CASES = {
    # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal, layout)
    # Skv=40 is not a multiple of the CUDA kernel's 64-key tile
    "ragged": (5, 2, 40, 40, 3, 16, [33, 40], False, "bshd"),
    "ragged-causal": (5, 2, 40, 40, 3, 16, [33, 40], True, "bshd"),
    "causal-37x40": (6, 2, 37, 40, 2, 16, [40, 11], True, "bshd"),
    "decode-1x24": (7, 2, 1, 24, 2, 8, [20, 24], True, "bshd"),
    "bhsd": (8, 2, 32, 32, 2, 16, [30, 32], False, "bhsd"),
    "mask-1xSkv": (9, 3, 13, 21, 2, 24, [17], True, "bshd"),
}
MASKED_ROW = {
    "masked-row": (10, 2, 40, 40, 3, 16, [0, 40], False, "bshd"),
    "masked-row-causal": (10, 2, 40, 40, 3, 16, [0, 40], True, "bshd"),
}


def _inputs(seed, b, sq, skv, h, d, lengths):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    mask = np.arange(skv)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, impl, dtype=jnp.float32):
    def loss(q, k, v):
        if impl == "reference":
            o = jax_attn.attention_reference(q, k, v, kv_mask=mask,
                                             causal=causal)
        else:
            o = jax_attn.attention(q, k, v, kv_mask=mask, causal=causal,
                                   impl=impl)
        return jnp.sum(o.astype(jnp.float32) * do)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, do, mask, causal, layout, fn):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tm = torch.from_numpy(mask.astype(np.int32))
    if layout == "bhsd":
        hq, hk, hv = (t.transpose(1, 2).contiguous() for t in (tq, tk, tv))
        out = fn(hq, hk, hv, tm, causal, layout="bhsd").transpose(1, 2)
    else:
        out = fn(tq, tk, tv, tm, causal)
    (out * torch.from_numpy(do)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _via_attention(q, k, v, mask, causal, layout="bshd"):
    return A.attention(q, k, v, kv_mask=mask, causal=causal, impl="short",
                       layout=layout)


def _via_function(q, k, v, mask, causal):
    return A.ShortAttention.apply(q, k, v, mask, causal,
                                  1.0 / np.sqrt(q.shape[-1]))


@pytest.fixture(autouse=True)
def _fresh_counts():
    A.short_attention_fwd.launches = 0
    A.short_attention_bwd.launches = 0
    yield
    # CPU tensors take the plain twins: no kernel launches
    assert A.short_attention_fwd.launches == 0
    assert A.short_attention_bwd.launches == 0


@pytest.mark.parametrize("name", sorted({**CASES, **MASKED_ROW}))
def test_grads_match_jax_reference(name):
    """attention(impl='short') through ShortAttention, the Function applied
    directly, and the plain backward twin called on its own, all against
    jax.grad(attention_reference)."""
    seed, b, sq, skv, h, d, lengths, causal, layout = {**CASES,
                                                       **MASKED_ROW}[name]
    q, k, v, do, mask = _inputs(seed, b, sq, skv, h, d, lengths)
    want = _jax_grads(q, k, v, do, mask, causal, "reference")
    got = _port_grads(q, k, v, do, mask, causal, layout, _via_attention)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    if layout == "bshd":
        got = _port_grads(q, k, v, do, mask, causal, layout, _via_function)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=ATOL)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = torch.from_numpy(mask)
    o = A.short_attention_fwd(tq, tk, tv, tm, causal)
    direct = A.short_attention_bwd(tq, tk, tv, tm, o, tdo, causal)
    for g, w in zip(direct, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax_short_kernel(name):
    """Against jax.grad of the JAX short kernel itself (interpret mode), on
    the cases without a fully masked row."""
    seed, b, sq, skv, h, d, lengths, causal, layout = CASES[name]
    q, k, v, do, mask = _inputs(seed, b, sq, skv, h, d, lengths)
    want = _jax_grads(q, k, v, do, mask, causal, "short")
    got = _port_grads(q, k, v, do, mask, causal, layout, _via_attention)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL_SHORT)


def test_fully_masked_row_does_not_copy_the_jax_short_kernel():
    """ROADMAP C7: on a fully masked row the JAX short backward does not
    zero dS at the masked keys, so its dq (and the dk it feeds) is not 0;
    jax.grad(attention_reference) and the port give dq = 0 there, and the
    row's dv is P^T dO with P uniform over the real keys."""
    seed, b, sq, skv, h, d, lengths, causal, _ = MASKED_ROW["masked-row"]
    q, k, v, do, mask = _inputs(seed, b, sq, skv, h, d, lengths)
    ref = _jax_grads(q, k, v, do, mask, causal, "reference")
    short = _jax_grads(q, k, v, do, mask, causal, "short")
    got = _port_grads(q, k, v, do, mask, causal, "bshd", _via_attention)
    assert np.abs(short[0][0]).max() > 0.1          # the JAX kernel's fault
    np.testing.assert_array_equal(ref[0][0], 0.0)
    np.testing.assert_array_equal(got[0][0], 0.0)   # dq of the masked row
    # batch row 0 has no key, so it gives dk nothing: dk[0] == 0
    np.testing.assert_array_equal(got[1][0], 0.0)
    dv_uniform = np.broadcast_to(do[0].sum(axis=0, keepdims=True) / skv,
                                 got[2][0].shape)
    np.testing.assert_allclose(got[2][0], dv_uniform, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_reference_grads_bit_identical_to_jax(causal):
    """bf16 attention_reference: autograd through the port's version gives
    jax.grad's dq, dk and dv bit for bit (atol 0). Both detach the row max
    (JAX's stop_gradient); without that the port's dq and dk move by an
    ulp."""
    rng = np.random.RandomState(11)
    b, s, h, d = 2, 32, 2, 16
    q, k, v = ((2 * rng.standard_normal((b, s, h, d))).astype(np.float32)
               for _ in range(3))
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    mask = np.arange(s)[None, :] < np.asarray([[20], [32]])
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jdo = jnp.asarray(do, jnp.bfloat16)

    def loss(q, k, v):
        o = jax_attn.attention_reference(q, k, v, kv_mask=jnp.asarray(mask),
                                         causal=causal)
        return jnp.sum((o * jdo).astype(jnp.float32))
    want = [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]

    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    out = A.attention_reference(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                                causal=causal)
    (out * torch.from_numpy(do).to(torch.bfloat16)).float().sum().backward()
    for t, w in zip((tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.grad.float().numpy(), w)


def test_function_grad_matches_central_difference():
    """The Function's gradient against a central difference of its own
    forward, in f32 on a tiny case with a masked key (the plain twins on CPU
    tensors): eps 1e-2 leaves an O(eps^2) error well inside 2e-3."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 1, 8)).astype(
        np.float64)).float() for _ in range(3))
    mask = torch.tensor([[1, 1, 1, 0, 1]], dtype=torch.int32)
    q.requires_grad_(True)
    out = A.ShortAttention.apply(q, k, v, mask, False, 0.35)
    out.sum().backward()
    eps = 1e-2
    num = torch.zeros_like(q)
    with torch.no_grad():
        for idx in np.ndindex(*q.shape):
            qp, qm = q.detach().clone(), q.detach().clone()
            qp[idx] += eps
            qm[idx] -= eps
            num[idx] = (A.short_attention_fwd_reference(qp, k, v, mask,
                                                        False, 0.35).sum()
                        - A.short_attention_fwd_reference(qm, k, v, mask,
                                                          False, 0.35).sum()
                        ) / (2 * eps)
    np.testing.assert_allclose(q.grad.numpy(), num.numpy(), atol=2e-3)


def test_bwd_wrapper_checks_o_and_do():
    q, k, v, do, mask = _inputs(13, 1, 8, 8, 1, 8, [8])
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = torch.from_numpy(mask)
    o = A.short_attention_fwd(tq, tk, tv, tm)
    with pytest.raises(ValueError, match="shape"):
        A.short_attention_bwd(tq, tk, tv, tm, o[:, :4], tdo)
    with pytest.raises(ValueError, match="dtype"):
        A.short_attention_bwd(tq, tk, tv, tm, o, tdo.double())


def _tensor_core_rounding(q, k, v, mask, o, do, causal):
    """The bf16 short backward's arithmetic in plain PyTorch, at the
    rounding points of its tensor-core routes (csrc/short_attention_bwd.cu):
    f32 scores and dP from the bf16 inputs, P the f32 softmax over the real
    keys (uniform over them on a fully masked row), dS = P (dP - delta)
    scale zeroed at hidden keys, P and dS rounded to bf16 before f32 sums,
    dq/dk/dv rounded to bf16. Returns f32 tensors."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    hidden = A._hidden_keys(mask, q.shape[1], k.shape[1], causal, q.device)
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s.masked_fill(hidden, A.NEG_INF), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).masked_fill(hidden, 0.0)
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, do)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q)
    return [g.bfloat16().float() for g in (dq, dk, dv)]


def _largest_error_over_bound(got, want, rss):
    """max |got - want| / bound over dq, dk, dv: the flash backward's bf16
    bound, which the card check holds the short backward's tensor-core
    routes to (chip_smoke.py, FLASH_BWD_*_BF16)."""
    worst = 0.0
    for g, w, r in zip(got, want, rss):
        bound = chip_smoke.FLASH_BWD_ATOL_BF16 \
            + chip_smoke.FLASH_BWD_RTOL_BF16 * w.abs() \
            + chip_smoke.FLASH_BWD_RSS_BF16 * r
        worst = max(worst, ((g.float() - w).abs() / bound).max().item())
    return worst


BUDGET_CASES = {
    # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal); the
    # first two take the one-block route on a card, the third the flash
    # route
    "bert-128-ragged": (31, 2, 128, 128, 2, 64, [128, 77], False),
    "decoder-64-causal-masked-row": (32, 2, 64, 64, 2, 64, [64, 0], True),
    "ragged-256": (33, 2, 256, 256, 2, 64, [256, 190], False),
}


@pytest.mark.parametrize("name", sorted(BUDGET_CASES))
def test_bf16_rounding_points_stay_within_the_card_bound(name):
    """The bf16 error budget of the short backward on the tensor cores.
    Its rounding points, emulated in plain PyTorch, stay within the flash
    backward's bound (1e-5 + 2^-8 |g| + 2.5 x 2^-8 R, R from
    flash_attention_bwd_rss given the forward twin's LSE) of the f32 twin on
    the same bf16 inputs; the bound of one rounding of the output (1e-4 +
    2^-8 |g|, which the CUDA-core walk met) no longer holds; and autograd
    through bf16 attention_reference, which also rounds the scores and dP,
    exceeds the new bound."""
    seed, b, sq, skv, h, d, lengths, causal = BUDGET_CASES[name]
    q, k, v, do, mask = (torch.from_numpy(x) for x in
                         _inputs(seed, b, sq, skv, h, d, lengths))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o32, lse = A.flash_attention_fwd_reference(q.float(), k.float(),
                                               v.float(), mask, causal)
    o = o32.bfloat16()
    args = (q.float(), k.float(), v.float(), mask, o.float(), do.float(),
            causal)
    want = A.short_attention_bwd_reference(*args)
    rss = A.flash_attention_bwd_rss(*args[:5], lse, *args[5:])
    emulated = _tensor_core_rounding(q, k, v, mask, o, do, causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = A.attention_reference(*leaves, kv_mask=mask, causal=causal)
    plain = torch.autograd.grad(out, leaves, do)
    ours = _largest_error_over_bound(emulated, want, rss)
    theirs = _largest_error_over_bound(plain, want, rss)
    assert 0.1 < ours <= 1.0, ours
    assert theirs > 1.0, theirs
    one_rounding = max(((g - w).abs() - 1e-4 - 2 ** -8 * w.abs()).max().item()
                       for g, w in zip(emulated, want))
    assert one_rounding > 0, one_rounding
