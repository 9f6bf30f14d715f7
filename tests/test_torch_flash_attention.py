"""The port's flash attention forward against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. JAX runs
its blocked `_fwd_kernel` in Pallas interpret mode on the CPU (as
test_attention.py runs it) with 32 x 32 blocks, so every case here spans
several query and key blocks; the port runs the kernel's plain twin
flash_attention_fwd_reference on CPU tensors. Bounds: f32, O and LSE within
2e-5 (test_attention.py's bound for the JAX flash kernel against its
reference). bf16 inputs: within 2e-2 of JAX's bf16 flash kernel, which
rounds P to bf16 before P.V (2^-9 relative per weight, so at most
2^-9 * max|v| ~ 8e-3 here) and O to bf16 (half an ulp of |o| < 4, 2^-7);
the twin keeps P in f32 and is held in f32. The bf16 tensor-core kernel's
bound, which the card check uses, is pinned here against an emulation of
its rounding points and against bf16 attention_reference.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from easynlp_tpu.ops import attention as jax_attn
from easynlp_tpu_torch.ops import attention as A

ATOL = 2e-5
BF16_ATOL = 2e-2
BLOCK = 32


def _case(seed, b, sq, skv, h, d, lengths):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for s in (sq, skv, skv))
    mask = np.arange(skv)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def _jax_flash(q, k, v, mask, causal, dtype=jnp.float32):
    out = jax_attn.attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                             kv_mask=jnp.asarray(mask), causal=causal,
                             impl="flash", block_q=BLOCK, block_k=BLOCK)
    return np.asarray(out.astype(jnp.float32))


def _jax_lse(q, k, v, mask, causal):
    """_flash_fwd's LSE [B,H,Sq] for the real rows, q/k/v padded to block
    multiples as attention() pads them (a padded key is masked and adds
    exp(-1e30 - m) = 0 to a real row's sum)."""
    sq, skv = q.shape[1], k.shape[1]
    pq, pk = (-sq) % BLOCK, (-skv) % BLOCK
    pad = ((0, 0), (0, pq), (0, 0), (0, 0))
    kpad = ((0, 0), (0, pk), (0, 0), (0, 0))
    _, lse = jax_attn._flash_fwd(
        jnp.asarray(np.pad(q, pad)), jnp.asarray(np.pad(k, kpad)),
        jnp.asarray(np.pad(v, kpad)), jnp.asarray(np.pad(mask,
                                                         ((0, 0), (0, pk)))),
        causal, 1.0 / np.sqrt(q.shape[-1]), BLOCK, BLOCK, None)
    return np.asarray(lse)[:, :, 0, :sq]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = {  # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal)
    "ragged-40": (1, 2, 40, 40, 2, 16, [40, 33], False),
    "ragged-100": (2, 2, 100, 100, 3, 16, [100, 61], False),
    "causal-70": (3, 2, 70, 70, 2, 16, [70, 52], True),
    "causal-32x64": (4, 2, 32, 64, 2, 8, [64, 47], True),
    "decode-1x600": (5, 2, 1, 600, 2, 16, [600, 317], False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_twin_matches_jax_flash(name):
    seed, b, sq, skv, h, d, lengths, causal = CASES[name]
    q, k, v, mask = _case(seed, b, sq, skv, h, d, lengths)
    want = _jax_flash(q, k, v, mask, causal)
    got, lse = A.flash_attention_fwd(*_torch(q, k, v, mask), causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, mask, causal),
                               atol=ATOL)
    # and the reference path, which the twin follows everywhere
    ref = A.attention_reference(*_torch(q, k, v, mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)

    got16, _ = A.flash_attention_fwd(
        *(t.to(torch.bfloat16) for t in _torch(q, k, v)),
        torch.from_numpy(mask), causal)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               _jax_flash(q, k, v, mask, causal,
                                          jnp.bfloat16), atol=BF16_ATOL)


def test_bhsd_layout_matches_jax_flash():
    q, k, v, mask = _case(6, 2, 48, 48, 2, 16, [48, 30])
    want = _jax_flash(q, k, v, mask, False)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in _torch(q, k, v))
    with torch.no_grad():
        got = A.attention(qh, kh, vh, kv_mask=torch.from_numpy(mask),
                          impl="flash", layout="bhsd")
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_does_not_copy_the_jax_flash_kernel(causal):
    """A query row whose keys are all masked: the port gives the mean of V
    over the real Skv keys, as attention_reference. JAX's flash path pads
    K/V to the block multiple (40 -> 64 keys) and its padded keys join the
    average, so its row is reference * 40/64 (ROADMAP C1). Under causal
    masking its tile skipping cuts the average further: rows of the first
    query block visit only the first 32 keys. Both write LSE -1e30 there:
    -1e30 + log(40) rounds to -1e30 in f32, so a backward that forms
    exp(s - LSE) would weigh every key 1, not 1/40 (ROADMAP C10)."""
    q, k, v, mask = _case(7, 2, 40, 40, 2, 8, [40, 0])
    ref = A.attention_reference(*_torch(q, k, v, mask), causal=causal)
    got, lse = A.flash_attention_fwd(*_torch(q, k, v, mask), causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(
        v[1].mean(axis=0), got.shape[1:]), atol=ATOL)
    want = _jax_flash(q, k, v, mask, causal)
    np.testing.assert_allclose(want[0], ref.numpy()[0], atol=ATOL)
    first = BLOCK if causal else 0  # rows that see only the first block
    np.testing.assert_allclose(want[1, :first], np.broadcast_to(
        v[1, :BLOCK].mean(axis=0), want[1, :first].shape), atol=ATOL)
    np.testing.assert_allclose(want[1, first:], ref.numpy()[1, first:]
                               * 40 / 64, atol=ATOL)
    assert (lse.numpy()[1] == np.float32(-1e30)).all()
    assert (_jax_lse(q, k, v, mask, causal)[1] == np.float32(-1e30)).all()


@pytest.mark.parametrize("sq,skv", [(37, 100), (20, 12)])
def test_causal_sq_ne_skv_with_padding_matches_jax_fallback(sq, skv):
    """Causal with Sq != Skv where block padding would shift the diagonal:
    JAX falls back to its XLA path (attention.py:782-786, ROADMAP C2); the
    port applies q_offset = Skv - Sq directly. (20, 12) has rows with
    q + q_offset < 0, which see no key."""
    q, k, v, mask = _case(8, 2, sq, skv, 2, 16, [skv, skv - 5])
    want = _jax_flash(q, k, v, mask, True)
    got, _ = A.flash_attention_fwd(*_torch(q, k, v, mask), True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.fixture
def spies(monkeypatch):
    calls = {"short": 0, "flash": 0}
    for name, fn_name in (("short", "short_attention_fwd"),
                          ("flash", "flash_attention_fwd")):
        real = getattr(A, fn_name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(A, fn_name, spy)
    A.set_kernel_override(None)
    yield calls
    A.set_kernel_override(None)


@pytest.mark.parametrize("skv,override,d,bias,want", [
    (520, None, 16, False, "flash"),
    (2048, True, 16, False, "flash"),
    (512, None, 16, False, "short"),
    (520, False, 16, False, "reference"),   # --use_flash_attention=false
    (520, None, 12, False, "reference"),    # head dim the kernels refuse
    (520, None, 16, True, "reference"),     # a bias forces the plain path
])
def test_auto_dispatch_without_grad(spies, skv, override, d, bias, want):
    A.set_kernel_override(override)
    q, k, v, mask = _case(9, 1, 4, skv, 2, d, [skv - 3])
    tq, tk, tv, tm = _torch(q, k, v, mask)
    tb = torch.zeros((1, 2, 4, skv)) if bias else None
    with torch.no_grad():
        out = A.attention(tq, tk, tv, kv_mask=tm, causal=True, bias=tb)
    assert spies == {"short": int(want == "short"),
                     "flash": int(want == "flash")}
    ref = A.attention_reference(tq, tk, tv, kv_mask=tm, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


def test_auto_with_grad_keeps_the_reference_above_512(spies):
    """With a gradient, auto now takes the flash path above 512 keys too
    (FlashAttention: the forward, then flash_attention_bwd), and the
    gradient is that of attention_reference."""
    q, k, v, mask = _case(10, 1, 8, 600, 2, 16, [590])
    leaves = [t.requires_grad_(True) for t in _torch(q, k, v)]
    out = A.attention(*leaves, kv_mask=torch.from_numpy(mask), causal=True)
    out.sum().backward()
    assert spies == {"short": 0, "flash": 1}
    ref_leaves = [t.requires_grad_(True) for t in _torch(q, k, v)]
    A.attention_reference(*ref_leaves, kv_mask=torch.from_numpy(mask),
                          causal=True).sum().backward()
    for t, r in zip(leaves, ref_leaves):
        assert t.grad.abs().sum() > 0
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), atol=ATOL)


def test_flash_with_grad_raises():
    """impl='flash' with a gradient runs FlashAttention and gives the
    reference's gradient; only the bare forward kernel, which records no
    gradient, still raises on an input that needs one."""
    q, k, v, mask = _case(11, 1, 8, 600, 2, 16, [600])
    tq, tk, tv, tm = _torch(q, k, v, mask)
    tq.requires_grad_(True)
    A.attention(tq, tk, tv, kv_mask=tm, impl="flash").sum().backward()
    rq = torch.from_numpy(q).requires_grad_(True)
    A.attention_reference(rq, tk, tv, kv_mask=tm).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), rq.grad.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="FlashAttention"):
        A.flash_attention_fwd(tq, tk, tv, tm)


@pytest.mark.parametrize("bad", ["head_dim", "mask_shape", "mask_dtype",
                                 "head_dim_stride", "no_keys"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, s, h, d = 2, 16, 2, 16
    q, k, v = _torch(*_case(12, b, s, s, h, d, [s, s])[:3])
    mask = torch.ones((b, s), dtype=torch.int32)
    if bad == "head_dim":
        q, k, v = _torch(*_case(12, b, s, s, h, 12, [s, s])[:3])
    elif bad == "mask_shape":
        mask = torch.ones((3, s), dtype=torch.int32)
    elif bad == "mask_dtype":
        mask = torch.ones((b, s), dtype=torch.float32)
    elif bad == "head_dim_stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "no_keys":
        k, v, mask = k[:, :0], v[:, :0], mask[:, :0]
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, k, v, mask)


def _tensor_core_rounding(q, k, v, mask, causal):
    """The bf16 tensor-core flash forward's arithmetic in plain PyTorch, at
    its rounding points (csrc/attention_fwd_mma.cuh): f32 scores from the
    bf16 inputs, p = exp(s - m) in f32 with m the row max (the kernel's
    running max rescales whole rows, so each rounding moves p by the same
    relative amount), l = the sum of the f32 p, p rounded to bf16 before an
    f32 P V, O = P V / l rounded to bf16. Returns f32 [B,Sq,H,D]."""
    hidden = A._hidden_keys(mask, q.shape[1], k.shape[1], causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    s = s.masked_fill(hidden, A.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), v.float()) \
        / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).bfloat16().float()


def _largest_error_over_bound(got, want, rss):
    """max |got - want| / bound, the bound the card check holds the bf16
    tensor-core forward to (chip_smoke.py, FLASH_FWD_*_BF16)."""
    bound = chip_smoke.FLASH_FWD_ATOL_BF16 \
        + chip_smoke.FLASH_FWD_RTOL_BF16 * want.abs() \
        + chip_smoke.FLASH_FWD_RSS_BF16 * rss
    return ((got.float() - want).abs() / bound).max().item()


BUDGET_CASES = {
    # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal)
    "ragged-256": (21, 2, 256, 256, 2, 64, [256, 177], False),
    "causal-masked-row-256": (22, 2, 256, 256, 2, 64, [256, 0], True),
    "causal-100x256": (23, 2, 100, 256, 2, 64, [256, 140], True),
}


@pytest.mark.parametrize("name", sorted(BUDGET_CASES))
def test_bf16_rounding_points_stay_within_the_card_bound(name):
    """The bf16 error budget of the tensor-core forward. Its rounding
    points, emulated in plain PyTorch, stay within chip_smoke.py's bound
    (1e-5 + 2^-8 |o| + 2.5 x 2^-8 R, R from flash_attention_fwd_rss) of the
    f32 twin on the same bf16 inputs, while bf16 attention_reference, which
    also rounds the max-subtracted scores and the normalised probabilities,
    does not at these sizes. The bound is not vacuous: the emulation uses
    more than a tenth of it."""
    seed, b, sq, skv, h, d, lengths, causal = BUDGET_CASES[name]
    q, k, v, mask = _torch(*_case(seed, b, sq, skv, h, d, lengths))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    args = (q.float(), k.float(), v.float(), mask, causal)
    want, _ = A.flash_attention_fwd_reference(*args)
    rss = A.flash_attention_fwd_rss(*args)
    ours = _largest_error_over_bound(
        _tensor_core_rounding(q, k, v, mask, causal), want, rss)
    theirs = _largest_error_over_bound(
        A.attention_reference(q, k, v, kv_mask=mask, causal=causal), want,
        rss)
    assert 0.1 < ours <= 1.0, ours
    assert theirs > 1.0, theirs


SHORT_BUDGET_CASES = {
    # name: (seed, B, Sq, Skv, H, D, per-row key lengths, causal); the bf16
    # short forward shares the flash forward's tile step and rounding points
    "ragged-128": (31, 4, 128, 128, 4, 64, [128, 100, 57, 1], False),
    "bart-decoder-8x64x64": (32, 8, 64, 64, 2, 64,
                             [64, 60, 51, 40, 33, 20, 9, 1], True),
    "masked-row-200": (33, 2, 200, 200, 2, 64, [200, 0], False),
    "decode-8x1x64": (34, 8, 1, 64, 4, 64, [64, 60, 51, 40, 33, 20, 9, 1],
                      True),
    # every row's second key tile is masked: the kernel skips it
    "masked-tail-128": (35, 4, 128, 128, 4, 64, [60, 33, 17, 1], False),
}


@pytest.mark.parametrize("name", sorted(SHORT_BUDGET_CASES))
def test_bf16_short_rounding_points_stay_within_the_card_bound(name):
    """The bf16 error budget of the tensor-core short forward at its main
    paths' shapes (BERT's ragged 128, BART's causal decoder 8 x 64 x 64, a
    decode step, a fully masked batch row, and a masked tail whose key tile
    the kernel skips, exactly). Its rounding points, emulated in plain
    PyTorch, stay within chip_smoke.py's bound (1e-5 + 2^-8 |o| +
    2.5 x 2^-8 R, R from flash_attention_fwd_rss) of the f32 twin
    short_attention_fwd_reference on the same bf16 inputs, and use more
    than a tenth of it."""
    seed, b, sq, skv, h, d, lengths, causal = SHORT_BUDGET_CASES[name]
    q, k, v, mask = _torch(*_case(seed, b, sq, skv, h, d, lengths))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    args = (q.float(), k.float(), v.float(), mask, causal)
    want = A.short_attention_fwd_reference(*args).float()
    rss = A.flash_attention_fwd_rss(*args)
    ours = _largest_error_over_bound(
        _tensor_core_rounding(q, k, v, mask, causal), want, rss)
    assert 0.1 < ours <= 1.0, ours
