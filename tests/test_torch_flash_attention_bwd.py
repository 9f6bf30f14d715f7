"""The port's flash attention backward against the JAX package's.

Inputs and the output gradient dO are made with numpy from a seed and handed
to both packages. The port runs its flash backward kernel's plain twin
flash_attention_bwd_reference on CPU tensors (with O and LSE from the
forward twin). JAX runs jax.grad of attention(impl='flash') with 32 x 32
blocks in Pallas interpret mode on the CPU (as tests/test_attention.py runs
it), so each case spans several query and key blocks and reaches
_bwd_dkdv_kernel and _bwd_dq_kernel; and jax.grad of attention_reference.

f32 bound: 2e-5 (the bound tests/test_attention.py holds the JAX flash
kernel to against its reference; the gradients here are below 20 in
magnitude, so about 1e-6 relative). The bf16 kernels' bound, which the card
check uses, is pinned here against an emulation of their rounding points
and against autograd through bf16 attention_reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from easynlp_tpu.ops import attention as jax_attn
from easynlp_tpu_torch.ops import attention as A

ATOL = 2e-5
BLOCK = 32

CASES = {
    # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal)
    "non-causal-20x100": (1, 2, 20, 100, 2, 16, [100, 100], False),
    "causal-100x100": (2, 2, 100, 100, 2, 16, [100, 100], True),
    "ragged-70x70": (3, 2, 70, 70, 2, 16, [70, 45], False),
    "ragged-causal-70x70": (4, 2, 70, 70, 2, 16, [70, 45], True),
}


def _inputs(seed, b, sq, skv, h, d, lengths):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for s in (sq, skv, skv))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    mask = np.arange(skv)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, impl):
    def loss(q, k, v):
        kw = dict(block_q=BLOCK, block_k=BLOCK) if impl == "flash" else {}
        o = jax_attn.attention(q, k, v, kv_mask=jnp.asarray(mask),
                               causal=causal, impl=impl, **kw)
        return jnp.sum(o * jnp.asarray(do))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in grads]


def _twin_grads(q, k, v, do, mask, causal):
    tq, tk, tv, tdo, tm = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    o, lse = A.flash_attention_fwd_reference(tq, tk, tv, tm, causal)
    return [g.numpy() for g in A.flash_attention_bwd_reference(
        tq, tk, tv, tm, o, lse, tdo, causal)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_jax_flash_grad(name):
    """The twin against jax.grad of the JAX flash kernels (interpret
    mode), dq, dk and dv within 2e-5; and through the port's wrapper on CPU
    tensors, which takes the twin."""
    seed, b, sq, skv, h, d, lengths, causal = CASES[name]
    q, k, v, do, mask = _inputs(seed, b, sq, skv, h, d, lengths)
    want = _jax_grads(q, k, v, do, mask, causal, "flash")
    got = _twin_grads(q, k, v, do, mask, causal)
    for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=gname)
    tq, tk, tv, tdo, tm = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    o, lse = A.flash_attention_fwd(tq, tk, tv, tm, causal)
    before = A.flash_attention_bwd.launches
    wrapped = A.flash_attention_bwd(tq, tk, tv, tm, o, lse, tdo, causal)
    assert A.flash_attention_bwd.launches == before  # CPU: the twin
    for g, w in zip(wrapped, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_rows_follow_attention_reference(causal):
    """ROADMAP C10: batch row 0 has no key, and under causal masking with
    Sq > Skv the first rows of row 1 see none either. The twin gives
    jax.grad(attention_reference)'s gradients: dq = 0 on those rows, no dk
    from them, and dO/Skv to every key's dv (causally hidden ones too)."""
    q, k, v, do, mask = _inputs(7, 2, 50, 40, 2, 16, [0, 40])
    want = _jax_grads(q, k, v, do, mask, causal, "reference")
    got = _twin_grads(q, k, v, do, mask, causal)
    for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=gname)
    np.testing.assert_array_equal(got[0][0], 0.0)
    np.testing.assert_array_equal(got[1][0], 0.0)
    np.testing.assert_allclose(
        got[2][0], np.broadcast_to(do[0].sum(0, keepdims=True) / 40,
                                   got[2][0].shape), atol=ATOL)
    if causal:  # q_offset = -10: rows 0..9 of batch row 1 see no key
        np.testing.assert_array_equal(got[0][1, :10], 0.0)


def test_fully_masked_row_does_not_copy_the_jax_flash_kernels():
    """ROADMAP C10: the JAX flash backward forms P = exp(s - LSE) with the
    masked row's LSE = -1e30, so every key of that row gets weight 1, not
    1/Skv, and its dv is Skv times too large; and its padded zero keys (K/V
    padded to the 32-block multiple, ROADMAP C1) share the row's dO too. The
    twin follows attention_reference."""
    q, k, v, do, mask = _inputs(8, 2, 40, 40, 2, 16, [0, 40])
    ref = _jax_grads(q, k, v, do, mask, False, "reference")
    flash = _jax_grads(q, k, v, do, mask, False, "flash")
    got = _twin_grads(q, k, v, do, mask, False)
    np.testing.assert_allclose(got[2][0], ref[2][0], atol=ATOL)
    np.testing.assert_allclose(flash[2][1], ref[2][1], atol=ATOL)  # row 1
    assert np.abs(flash[2][0] - ref[2][0]).max() > 1.0   # the JAX fault
    np.testing.assert_allclose(flash[2][0], 40 * ref[2][0], rtol=1e-4,
                               atol=1e-3)


def test_auto_with_grad_above_512_matches_reference():
    """autograd through attention(impl='auto') at Skv = 520 (FlashAttention:
    the forward twin, then the backward twin) against autograd through
    attention_reference, f32, a padded row and causal masking with
    Sq != Skv."""
    q, k, v, do, mask = _inputs(9, 2, 24, 520, 2, 16, [520, 301])
    grads = {}
    for impl in ("auto", "reference"):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = A.attention(*leaves, kv_mask=torch.from_numpy(mask),
                          causal=True, impl=impl)
        (out * torch.from_numpy(do)).sum().backward()
        grads[impl] = [t.grad.numpy() for t in leaves]
    for g, w, gname in zip(grads["auto"], grads["reference"],
                           ("dq", "dk", "dv")):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=gname)


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "do_shape"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, do, mask = (torch.from_numpy(x) for x in
                         _inputs(10, 2, 16, 16, 2, 16, [16, 9]))
    o, lse = A.flash_attention_fwd(q, k, v, mask)
    if bad == "lse_shape":
        lse = lse[:, :, :-1]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_shape":
        do = do[:, :-1]
    with pytest.raises(ValueError):
        A.flash_attention_bwd(q, k, v, mask, o, lse, do)


def _tensor_core_rounding(q, k, v, mask, o, lse, do, causal):
    """The bf16 flash backward kernels' arithmetic in plain PyTorch, at
    their rounding points (csrc/attention_bwd_mma.cuh): f32 scores and dP
    from the bf16 inputs, P = exp(s * scale - LSE), 0 at hidden keys and on
    fully masked rows, dS = P (dP - delta) scale, P and dS rounded to bf16
    before f32 sums, each fully masked row's dO / Skv added to dv in f32
    (the pre-pass), and dq/dk/dv rounded to bf16. Returns f32 tensors."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    skv = k.shape[1]
    hidden = A._hidden_keys(mask, q.shape[1], skv, causal, q.device)
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    masked = (lse < A.MASKED_ROW_LSE)[..., None]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.where(hidden | masked, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    p16, ds16 = (x.bfloat16().float() for x in (p, p * (dp - delta) * scale))
    masked_do = torch.einsum("bhq,bqhd->bhd", masked[..., 0].float(), do)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, do) \
        + masked_do[:, None] / skv
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q)
    return [g.bfloat16().float() for g in (dq, dk, dv)]


def _largest_error_over_bound(got, want, rss):
    """max |got - want| / bound over dq, dk, dv, the bound the card check
    holds the bf16 flash backward to (chip_smoke.py, FLASH_BWD_*_BF16)."""
    worst = 0.0
    for g, w, r in zip(got, want, rss):
        bound = chip_smoke.FLASH_BWD_ATOL_BF16 \
            + chip_smoke.FLASH_BWD_RTOL_BF16 * w.abs() \
            + chip_smoke.FLASH_BWD_RSS_BF16 * r
        worst = max(worst, ((g.float() - w).abs() / bound).max().item())
    return worst


BUDGET_CASES = {
    # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal)
    "fully-masked-row": (11, 2, 40, 150, 2, 64, [150, 0], False),
    "causal-offset-60-ragged": (12, 2, 70, 130, 2, 64, [130, 97], True),
    "causal-offset-minus-10": (13, 2, 50, 40, 2, 32, [40, 29], True),
}


@pytest.mark.parametrize("name", sorted(BUDGET_CASES))
def test_bf16_rounding_points_stay_within_the_card_bound(name):
    """The bf16 error budget the card check relies on. The kernels'
    rounding points, emulated in plain PyTorch, stay within chip_smoke.py's
    bound (1e-5 + 2^-8 |g| + 2.5 x 2^-8 R) of the f32 twin on the same bf16
    inputs, and no less tightly than autograd through bf16
    attention_reference, which rounds the same P and dS and also the
    scores and dP."""
    seed, b, sq, skv, h, d, lengths, causal = BUDGET_CASES[name]
    q, k, v, do, mask = (torch.from_numpy(x) for x in
                         _inputs(seed, b, sq, skv, h, d, lengths))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o, lse = A.flash_attention_fwd_reference(q, k, v, mask, causal)
    args = (q.float(), k.float(), v.float(), mask, o.float(), lse,
            do.float(), causal)
    want = A.flash_attention_bwd_reference(*args)
    rss = A.flash_attention_bwd_rss(*args)
    emulated = _tensor_core_rounding(q, k, v, mask, o, lse, do, causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = A.attention_reference(*leaves, kv_mask=mask, causal=causal)
    plain = torch.autograd.grad(out, leaves, do)
    ours = _largest_error_over_bound(emulated, want, rss)
    theirs = _largest_error_over_bound(plain, want, rss)
    assert ours <= 1.0, ours
    assert ours <= theirs, (ours, theirs)
    # the bound is not vacuous: the last rounding alone moves dq/dk/dv
    assert ours > 0.1, ours
