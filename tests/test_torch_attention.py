"""The PyTorch port's attention against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. JAX runs
on the CPU, its short kernel in Pallas interpret mode (as test_attention.py
runs it); the port runs its plain twin of the CUDA kernel on CPU tensors.
f32 parity bound: 2e-5, the bound test_attention.py holds the JAX short
kernel to against its reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.ops import attention as jax_attn
from easynlp_tpu_torch.ops import attention as A

ATOL = 2e-5


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, h, d)).astype(np.float32))


def _lengths_mask(lengths, skv):
    return (np.arange(skv)[None, :] < np.asarray(lengths)[:, None])


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(autouse=True)
def _fresh_dispatch_state():
    A.set_kernel_override(None)
    A.short_attention_fwd.launches = 0
    yield
    A.set_kernel_override(None)


@pytest.mark.parametrize("case", [
    # (seed, B, Sq, Skv, H, D, per-row lengths, causal, layout)
    (5, 2, 40, 40, 3, 16, [33, 40], False, "bshd"),   # test_attention.py:85
    (5, 2, 40, 40, 3, 16, [33, 40], True, "bshd"),
    (6, 2, 1, 24, 2, 8, [20, 20], True, "bshd"),      # decode shape, :115
    (7, 2, 32, 32, 2, 16, [30, 30], False, "bhsd"),   # heads-major, :128
], ids=["masked", "masked-causal", "decode-causal", "bhsd"])
def test_attention_matches_jax(case):
    seed, b, sq, skv, h, d, lengths, causal, layout = case
    q, k, v = _qkv(seed, b, sq, skv, h, d)
    mask = _lengths_mask(lengths, skv)
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    want_ref = np.asarray(jax_attn.attention_reference(
        jq, jk, jv, kv_mask=jm, causal=causal))
    want_short = np.asarray(jax_attn.attention(
        jq, jk, jv, kv_mask=jm, causal=causal, impl="short"))
    tq, tk, tv, tm = _torch(q, k, v, mask)

    got_ref = A.attention_reference(tq, tk, tv, kv_mask=tm, causal=causal)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=ATOL)

    if layout == "bhsd":
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (tq, tk, tv))
    got = A.attention(tq, tk, tv, kv_mask=tm.to(torch.int32), causal=causal,
                      layout=layout)
    if layout == "bhsd":
        got = got.transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want_short, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL)
    # on CPU tensors 'auto' took the plain twin: no kernel launch
    assert A.short_attention_fwd.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_averages_real_keys(causal):
    """A query row whose keys are all masked gives the mean of V over the
    real Skv keys, as the JAX attention_reference does (the JAX short kernel
    is held to the reference only here: with Skv not a multiple of 8 its
    padded keys join the average, ROADMAP C)."""
    b, s, h, d = 2, 40, 3, 16
    q, k, v = _qkv(9, b, s, s, h, d)
    mask = _lengths_mask([0, 40], s)
    want = np.asarray(jax_attn.attention_reference(
        *map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(mask),
        causal=causal))
    tq, tk, tv, tm = _torch(q, k, v, mask)
    for got in (A.short_attention_fwd(tq, tk, tv, tm, causal),
                A.attention_reference(tq, tk, tv, kv_mask=tm, causal=causal)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(want[0], np.broadcast_to(
        v[0].mean(axis=0, keepdims=True), want[0].shape), atol=ATOL)


def test_broadcast_mask_and_ragged_lengths():
    """[1,Skv] masks broadcast over the batch; Sq != Skv, neither a
    multiple of 8."""
    q, k, v = _qkv(11, 3, 13, 21, 2, 24)
    mask = _lengths_mask([17], 21)
    want = np.asarray(jax_attn.attention_reference(
        *map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(mask),
        causal=True))
    tq, tk, tv, tm = _torch(q, k, v, mask)
    got = A.attention(tq, tk, tv, kv_mask=tm, causal=True, impl="short")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_bias_forces_reference_path(monkeypatch):
    q, k, v = _qkv(12, 2, 16, 16, 2, 8)
    bias = np.random.RandomState(13).standard_normal(
        (2, 2, 16, 16)).astype(np.float32)
    mask = _lengths_mask([10, 16], 16)
    want = np.asarray(jax_attn.attention(
        *map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(mask),
        bias=jnp.asarray(bias), impl="short"))

    def no_kernel(*a, **kw):
        raise AssertionError("the short path must not run with a bias")
    monkeypatch.setattr(A, "short_attention_fwd", no_kernel)
    tq, tk, tv, tm, tb = _torch(q, k, v, mask, bias)
    got = A.attention(tq, tk, tv, kv_mask=tm, bias=tb, impl="short")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("override,skv,takes_short", [
    (None, 40, True), (True, 40, True), (False, 40, False),
    (None, 520, False)])
def test_auto_dispatch(monkeypatch, override, skv, takes_short):
    """auto: the short path up to 512 keys unless --use_flash_attention=false
    set the override; attention_reference above 512."""
    calls = []
    real = A.short_attention_fwd

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(A, "short_attention_fwd", spy)
    A.set_kernel_override(override)
    q, k, v = _qkv(14, 1, 8, skv, 2, 8)
    tq, tk, tv = _torch(q, k, v)
    out = A.attention(tq, tk, tv)
    assert bool(calls) == takes_short
    want = A.attention_reference(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("dtype,sq,skv,fwd,bwd", [
    (torch.float32, 128, 128, 0, 0),
    (torch.float32, 1, 512, 0, 0),
    (torch.bfloat16, 128, 128, 1, 1),
    (torch.bfloat16, 1, 512, 1, 2),
    (torch.bfloat16, 129, 64, 1, 2),
])
def test_short_kernel_routes_are_a_rule_on_dtype_and_shape(dtype, sq, skv,
                                                           fwd, bwd):
    """The dtype codes the wrappers hand csrc/short_attention_{fwd,bwd}.cu:
    f32 takes the CUDA-core walks (the only ones within the f32 twins' 2e-5
    bound); bf16 the tensor cores: the forward at every shape, the backward
    in one block per (b, h) up to 128 queries and keys and through the flash
    backward's passes above."""
    assert A._short_fwd_route(dtype) == fwd
    assert A._short_bwd_route(dtype, sq, skv) == bwd


@pytest.mark.parametrize("impl", ["flash", "ring"])
def test_unported_impls_raise(impl):
    """'ring' is not ported and raises. 'flash' is, backward included
    (FlashAttention): with an input that needs a gradient it now gives
    attention_reference's gradient instead of raising."""
    tq, tk, tv = _torch(*_qkv(15, 1, 8, 8, 2, 8))
    tq.requires_grad_(True)
    if impl == "ring":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            A.attention(tq, tk, tv, impl=impl)
        return
    A.attention(tq, tk, tv, impl=impl).sum().backward()
    rq = tq.detach().clone().requires_grad_(True)
    A.attention_reference(rq, tk, tv).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), rq.grad.numpy(), atol=ATOL)


@pytest.mark.parametrize("bad", ["head_dim", "long", "mask_shape",
                                 "mask_dtype", "grad", "head_dim_stride"])
def test_short_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, s, h, d = 2, 16, 2, 16
    q, k, v = _torch(*_qkv(16, b, s, s, h, d))
    mask = torch.ones((b, s), dtype=torch.int32)
    err = ValueError
    if bad == "head_dim":
        q, k, v = _torch(*_qkv(16, b, s, s, h, 12))
    elif bad == "long":
        q, k, v = _torch(*_qkv(16, b, s, 513, h, d))
        mask = torch.ones((b, 513), dtype=torch.int32)
    elif bad == "mask_shape":
        mask = torch.ones((3, s), dtype=torch.int32)
    elif bad == "mask_dtype":
        mask = torch.ones((b, s), dtype=torch.float32)
    elif bad == "grad":
        # the bare forward kernel records no gradient: attention() and
        # ShortAttention carry its backward
        q.requires_grad_(True)
    elif bad == "head_dim_stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err):
        A.short_attention_fwd(q, k, v, mask)


def test_bf16_reference_matches_jax():
    """bf16 path of attention_reference, including its bf16 score cast,
    against the JAX reference on the same bf16 inputs. Bound 2e-2: the two
    frameworks round the bf16 scores and probabilities at the same points
    but sum in different orders, which moves a bf16 value by an ulp
    (2^-8 relative) at most; outputs here are below 3 in magnitude."""
    q, k, v = _qkv(17, 2, 24, 24, 2, 16)
    mask = _lengths_mask([20, 24], 24)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_attn.attention_reference(
        jq, jk, jv, kv_mask=jnp.asarray(mask)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = A.attention_reference(tq, tk, tv, kv_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)
