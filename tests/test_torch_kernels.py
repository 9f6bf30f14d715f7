"""The port's kernel build and the CUDA kernels themselves.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest
The build tests run anywhere (a stand-in script plays nvcc); the kernel tests
are marked `gpu` and skip themselves where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from easynlp_tpu_torch import kernels
from easynlp_tpu_torch.ops import attention as A


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no such intrinsic' >&2\nexit 2\n")
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        kernels._build("short_attention_fwd")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_keyed_by_sources_and_flags(tmp_path, monkeypatch):
    # writes the file named after -o, and a ptxas-like line on stderr
    nvcc = _fake_nvcc(tmp_path, (
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
        'done\n'
        'echo "ptxas info    : Used 64 registers" >&2\n'
        ': > "$out"\n'))
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    path, info = kernels._build("short_attention_fwd")
    assert path.exists() and not info["cached"]
    assert "Used 64 registers" in info["log"]
    again, info2 = kernels._build("short_attention_fwd")
    assert again == path and info2["cached"] and info2["log"] == info["log"]
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-g",))
    assert kernels._build("short_attention_fwd")[0] != path
    with pytest.raises(FileNotFoundError):
        kernels._build("no_such_kernel")


def _case(seed, b, sq, skv, h, d, lengths, device):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).to(device) for s in (sq, skv, skv))
    mask = torch.from_numpy(np.arange(skv)[None, :]
                            < np.asarray(lengths)[:, None]).to(device)
    return q, k, v, mask


FWD_CASES = [  # B, Sq, Skv, H, D, per-row key lengths, causal
    (2, 40, 40, 3, 16, [0, 33], False),     # fully masked row
    (2, 1, 24, 2, 64, [20, 24], True),      # decode shape: Sq = 1, one warp
    (2, 37, 40, 2, 64, [40, 11], True),     # causal Sq != Skv, ragged
    (2, 20, 12, 2, 32, [12, 5], True),      # q_offset < 0: rows see no key
    (3, 70, 130, 2, 128, [130, 65, 1], False),  # D = 128
    (2, 16, 16, 2, 40, [16, 9], False),     # D not a power of two
    (2, 50, 90, 2, 8, [90, 31], False),     # D = 8, zero-filled to 16
    # BERT's shape: rows 2 and 3 skip their second (fully masked) key tile
    (4, 128, 128, 12, 64, [128, 100, 57, 1], False),
    # two 64-key tiles and 64-row query blocks up to 128, three from 129
    # (the third of one row)
    (2, 128, 128, 2, 64, [128, 3], True),
    (2, 129, 129, 2, 64, [129, 3], True),
    (2, 200, 300, 2, 64, [300, 0], True),   # causal Sq != Skv past 128
    # five query blocks; row 1 walks one key tile of eight, row 2 four
    (3, 300, 512, 2, 64, [512, 60, 200], False)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_twin():
    """The short forward kernel against its plain twin on the card, at
    FWD_CASES' shapes: fully masked rows, Sq = 1, causal Sq != Skv, D = 8,
    40 and 128, both sides of the 128/129 tile boundary, and rows
    whose trailing key tiles the mask hides (the bf16 kernel skips them).

    f32 takes the CUDA-core walk: within 2e-5 (the JAX short kernel's bound
    against its reference). bf16 takes the tensor cores, which round each
    unnormalised probability to bf16 before P V: within the flash forward's
    bound 1e-5 + 2^-8 |o| + 2.5 x 2^-8 R of the f32 twin on the same bf16
    inputs (chip_smoke.py, FLASH_FWD_*_BF16). Two bf16 runs give the same
    bits, and so does the bf16 flash forward, which shares the tile step but
    walks every key tile: skipping the tiles the mask hides is exact. Then
    BERT's layout (q/k/v as [B,S,H,D] views of the projections' [B,S,H*D]
    outputs) and heads-major input with a [1,Skv] mask, read in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate(FWD_CASES):
        q, k, v, mask = _case(i, b, sq, skv, h, d, lengths, dev)
        want = A.short_attention_fwd_reference(q, k, v, mask, causal)
        before = A.short_attention_fwd.launches
        got = A.short_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        assert A.short_attention_fwd.launches == before + 1
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
        got16 = A.short_attention_fwd(bq, bk, bv, mask, causal)
        _assert_fwd_bf16(got16, bq, bk, bv, mask, causal)
        assert torch.equal(A.short_attention_fwd(bq, bk, bv, mask, causal),
                           got16)
        flash16, _ = A.flash_attention_fwd(bq, bk, bv, mask, causal)
        assert torch.equal(flash16, got16), "case %d: not the flash bits" % i
    b, s, h, d = 2, 128, 12, 64
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1, 45:] = 0
    q, k, v = (torch.randn(b, s, h * d, device=dev).bfloat16().view(
        b, s, h, d) for _ in range(3))
    _assert_fwd_bf16(A.short_attention_fwd(q, k, v, mask), q, k, v, mask,
                     False)
    q, k, v, mask = _case(9, 2, 48, 48, 4, 64, [41], dev)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = A.attention(qh, kh, vh, kv_mask=mask, layout="bhsd")
    assert got.is_contiguous()
    want = A.short_attention_fwd_reference(q, k, v, mask).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    got16 = A.attention(*(t.bfloat16() for t in (qh, kh, vh)), kv_mask=mask,
                        layout="bhsd")
    _assert_fwd_bf16(got16.transpose(1, 2), *(t.bfloat16() for t in (q, k, v)),
                     mask, False)


BWD_CASES = [  # B, Sq, Skv, H, D, per-row key lengths, causal
    (2, 40, 40, 3, 16, [0, 33], False),     # fully masked row
    (2, 1, 24, 2, 64, [20, 24], True),      # decode shape
    (2, 37, 40, 2, 64, [40, 11], True),     # Sq != Skv, ragged
    (2, 20, 12, 2, 32, [12, 5], True),      # q_offset < 0: rows see no key
    (3, 70, 130, 2, 128, [130, 65, 1], False),
    (2, 16, 16, 2, 40, [16, 9], False),     # D not a power of two
    (4, 128, 128, 12, 64, [128, 100, 57, 1], False),
    # the bf16 routes' boundary: one block per (b, h) up to 128 keys and
    # queries, the flash backward's passes from 129
    (2, 128, 128, 2, 8, [128, 3], True),    # D = 8, zero-filled to 16
    (2, 129, 129, 2, 8, [129, 3], True),
    (2, 128, 128, 2, 128, [128, 0], False),  # D = 128, a fully masked row
    (2, 200, 300, 2, 40, [300, 0], True)]   # causal Sq != Skv past 128


def _assert_bwd_bf16(got, q, k, v, mask, o, do, causal):
    """got (bf16 dq, dk, dv of the short backward) within the flash
    backward's bf16 bound of the f32 twin on the same (bf16) inputs, with R
    from flash_attention_bwd_rss given the forward twin's LSE."""
    args = (q.float(), k.float(), v.float(), mask, o.float(), do.float(),
            causal)
    _, lse = A.flash_attention_fwd_reference(*args[:4], causal)
    want = A.short_attention_bwd_reference(*args)
    rss = A.flash_attention_bwd_rss(*args[:5], lse, *args[5:])
    for g, w, r, name in zip(got, want, rss, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        bound = chip_smoke.FLASH_BWD_ATOL_BF16 \
            + chip_smoke.FLASH_BWD_RTOL_BF16 * w.abs() \
            + chip_smoke.FLASH_BWD_RSS_BF16 * r
        excess = ((g.float() - w).abs() - bound).max().item()
        assert excess <= 0, "%s off by %.3e past its bound" % (name, excess)


@pytest.mark.gpu
def test_cuda_bwd_kernel_matches_plain_twin():
    """The backward kernel against its plain twin on the card, on the same
    inputs (q, k, v, the forward kernel's output o, dO; bf16 ones cast to
    f32 for the twin), at BWD_CASES' shapes: fully masked rows, ragged and
    causal edges, Sq = 1, Sq != Skv, D = 8, 40 and 128, and both sides of
    the bf16 routes' 128/129 boundary; then q/k/v read through GPT-2's
    fused-projection strides.

    f32 takes the CUDA-core walk: bound 2e-5 + 1e-5 |g| (sums in another
    order; dv reaches ~40 where one key carries a whole row). bf16 takes the
    tensor cores, which round P and dS to bf16 before their products: the
    flash backward's bound 1e-5 + 2^-8 |g| + 2.5 x 2^-8 R (chip_smoke.py,
    derived beside FLASH_BWD_RSS_BF16). Two runs give the same bits in both
    dtypes (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate(BWD_CASES):
        q, k, v, mask = _case(i, b, sq, skv, h, d, lengths, dev)
        do = torch.from_numpy(np.random.RandomState(100 + i).standard_normal(
            (b, sq, h, d)).astype(np.float32)).to(dev)
        o = A.short_attention_fwd(q, k, v, mask, causal)
        want = A.short_attention_bwd_reference(q, k, v, mask, o, do, causal)
        before = A.short_attention_bwd.launches
        got = A.short_attention_bwd(q, k, v, mask, o, do, causal)
        torch.cuda.synchronize()
        assert A.short_attention_bwd.launches == before + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
        again = A.short_attention_bwd(q, k, v, mask, o, do, causal)
        assert all(torch.equal(a, g) for a, g in zip(again, got))
        bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o16 = A.short_attention_fwd(bq, bk, bv, mask, causal)
        got16 = A.short_attention_bwd(bq, bk, bv, mask, o16, bdo, causal)
        _assert_bwd_bf16(got16, bq, bk, bv, mask, o16, bdo, causal)
        again16 = A.short_attention_bwd(bq, bk, bv, mask, o16, bdo, causal)
        assert all(torch.equal(a, g) for a, g in zip(again16, got16))
    # GPT-2's layout: q/k/v as views of one fused [B,S,3,H,D] projection,
    # read in place through its strides, on both bf16 routes
    for s_len in (128, 200):
        qkv = torch.randn(2, s_len, 3, 4, 64, device=dev).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        mask = torch.ones(2, s_len, dtype=torch.int32, device=dev)
        mask[1, :77] = 0
        do = torch.randn(2, s_len, 4, 64, device=dev).bfloat16()
        o = A.short_attention_fwd(q, k, v, mask, True)
        got = A.short_attention_bwd(q, k, v, mask, o, do, True)
        _assert_bwd_bf16(got, q, k, v, mask, o, do, True)


@pytest.mark.gpu
def test_cuda_autograd_through_attention():
    """attention() with requires_grad on the card: ShortAttention launches
    both kernels once, in both layouts and with a [1,Skv] mask, and its
    gradients match the plain twins' (dO strided through a reshape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    q, k, v, mask = _case(11, 2, 48, 48, 4, 64, [41], dev)
    do = torch.from_numpy(np.random.RandomState(12).standard_normal(
        (2, 48, 4, 64)).astype(np.float32)).to(dev)
    for layout in ("bshd", "bhsd"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        args = ([t.transpose(1, 2) for t in leaves] if layout == "bhsd"
                else leaves)
        fwd = A.short_attention_fwd.launches
        bwd = A.short_attention_bwd.launches
        out = A.attention(*args, kv_mask=mask, layout=layout)
        if layout == "bhsd":
            out = out.transpose(1, 2)
        (out * do).sum().backward()
        torch.cuda.synchronize()
        assert A.short_attention_fwd.launches == fwd + 1
        assert A.short_attention_bwd.launches == bwd + 1
        o = A.short_attention_fwd_reference(q, k, v, mask)
        want = A.short_attention_bwd_reference(q, k, v, mask, o, do)
        for t, w in zip(leaves, want):
            torch.testing.assert_close(t.grad, w, atol=2e-5, rtol=1e-5)


FLASH_CASES = [  # B, Sq, Skv, H, D, per-row key lengths, causal
    (2, 40, 40, 3, 16, [0, 33], False),       # fully masked row
    (2, 70, 70, 2, 64, [70, 51], True),       # causal, ragged
    (2, 1, 600, 2, 64, [600, 411], False),    # decode against a long cache
    (2, 37, 600, 2, 64, [600, 0], True),      # causal Sq != Skv, masked row
    (2, 20, 12, 2, 32, [12, 5], True),        # q_offset < 0: rows see no key
    (3, 100, 100, 2, 128, [100, 65, 1], False),
    (2, 16, 130, 2, 40, [130, 9], False),     # D not a power of two
    (1, 1100, 1100, 4, 64, [1100], True),
    (2, 50, 90, 2, 8, [90, 31], False),       # D = 8, zero-filled to 16
    # causal, q_offset = 170 across several 64-row and 64-key tiles
    (2, 130, 300, 2, 64, [300, 211], True)]


def _assert_flash_bwd_bf16(got, q, k, v, mask, o, lse, do, causal):
    """got (bf16 dq, dk, dv) within the bf16 flash backward's bound of the
    f32 twin on the same (bf16) inputs: chip_smoke.py's, derived there
    beside FLASH_BWD_RSS_BF16 (1e-5 + 2^-8 |g| + 2.5 x 2^-8 R, R from
    flash_attention_bwd_rss)."""
    args = (q.float(), k.float(), v.float(), mask, o.float(), lse,
            do.float(), causal)
    want = A.flash_attention_bwd_reference(*args)
    rss = A.flash_attention_bwd_rss(*args)
    for g, w, r, name in zip(got, want, rss, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        bound = chip_smoke.FLASH_BWD_ATOL_BF16 \
            + chip_smoke.FLASH_BWD_RTOL_BF16 * w.abs() \
            + chip_smoke.FLASH_BWD_RSS_BF16 * r
        excess = ((g.float() - w).abs() - bound).max().item()
        assert excess <= 0, "%s off by %.3e past its bound" % (name, excess)


def _assert_fwd_bf16(got, q, k, v, mask, causal):
    """got (bf16 O of the flash forward) within the tensor-core forward's
    bound of the f32 twin on the same (bf16) inputs: chip_smoke.py's,
    derived there beside FLASH_FWD_RSS_BF16 (1e-5 + 2^-8 |o| +
    2.5 x 2^-8 R, R from flash_attention_fwd_rss)."""
    args = (q.float(), k.float(), v.float(), mask, causal)
    want, _ = A.flash_attention_fwd_reference(*args)
    bound = chip_smoke.FLASH_FWD_ATOL_BF16 \
        + chip_smoke.FLASH_FWD_RTOL_BF16 * want.abs() \
        + chip_smoke.FLASH_FWD_RSS_BF16 * A.flash_attention_fwd_rss(*args)
    assert got.dtype == torch.bfloat16
    excess = ((got.float() - want).abs() - bound).max().item()
    assert excess <= 0, "O off by %.3e past its bound" % excess


@pytest.mark.gpu
def test_cuda_flash_fwd_matches_plain_twin():
    """The flash forward kernel against its plain twin on the card: O and
    LSE. f32 (the CUDA-core walk): O within 2e-5 (the JAX flash kernel's
    bound against its reference in test_attention.py), LSE within 2e-5 +
    1e-6 |lse| (a fully masked row's -1e30 must match too). bf16 inputs (the
    tensor cores, which round P to bf16 before P V): O within 1e-5 +
    2^-8 |o| + 2.5 x 2^-8 R of the f32 twin on the same bf16 inputs
    (chip_smoke.py, FLASH_FWD_*_BF16), LSE within 1e-4 (computed in f32
    from the same inputs); two bf16 runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate(FLASH_CASES):
        q, k, v, mask = _case(i, b, sq, skv, h, d, lengths, dev)
        want, want_lse = A.flash_attention_fwd_reference(q, k, v, mask,
                                                         causal)
        before = A.flash_attention_fwd.launches
        got, lse = A.flash_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        assert A.flash_attention_fwd.launches == before + 1
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=1e-6)
        bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
        got16, lse16 = A.flash_attention_fwd(bq, bk, bv, mask, causal)
        _, want_lse16 = A.flash_attention_fwd_reference(
            bq.float(), bk.float(), bv.float(), mask, causal)
        _assert_fwd_bf16(got16, bq, bk, bv, mask, causal)
        torch.testing.assert_close(lse16, want_lse16, atol=1e-4, rtol=1e-6)
        again16, _ = A.flash_attention_fwd(bq, bk, bv, mask, causal)
        assert torch.equal(again16, got16)
    # GPT-2's layouts, read in place: q/k/v as views of one fused
    # [B,S,3,H,D] projection (prefill), and q against a [B,T,H,D] cache
    # (decode) under auto dispatch
    b, s, h, d = 2, 600, 4, 64
    qkv = torch.randn(b, s, 3, h, d, device=dev, dtype=torch.bfloat16)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1, :77] = 0
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with torch.no_grad():
        before = A.flash_attention_fwd.launches
        got = A.attention(q, k, v, kv_mask=mask, causal=True)
        assert A.flash_attention_fwd.launches == before + 1
    _assert_fwd_bf16(got, q, k, v, mask, True)
    with torch.no_grad():
        got = A.attention(q[:, -1:], k, v, kv_mask=mask)
    _assert_fwd_bf16(got, q[:, -1:], k, v, mask, False)


@pytest.mark.gpu
def test_cuda_flash_bwd_matches_plain_twin():
    """The flash backward kernels against their plain twin on the card, on
    the same inputs (q, k, v, the forward kernel's O and LSE, dO; bf16 ones
    cast to f32 for the twin), at FLASH_CASES' shapes: fully masked rows,
    ragged and causal edges, Sq != Skv, q_offset < 0 and > 0 across several
    tiles, D = 8, 40 and 128; then q/k/v read through GPT-2's
    fused-projection strides (views of one [B,S,3,H,D] tensor).

    f32 takes the CUDA-core walk: bound 2e-5 + 1e-5 |g| (sums in another
    order). bf16 takes the tensor-core passes, which round each P and dS
    term to bf16 (at most 2^-8 of itself) before an f32 sum, then dq/dk/dv:
    the error is at most 2^-8 |g| from the last rounding plus a sum of
    terms x_j y_j each moved by at most 2^-8 of itself, whose spread over
    random inputs is about 0.43 x 2^-8 R, R = sqrt(sum_j (x_j y_j)^2)
    (flash_attention_bwd_rss); bound 1e-5 + 2^-8 |g| + 2.5 x 2^-8 R, which
    autograd through bf16 attention_reference (it also rounds the scores
    and dP) exceeds on the same inputs (chip_smoke.py checks that at its
    shapes; tests/test_torch_flash_attention_bwd.py on the CPU). Two runs
    give the same bits in both dtypes (no atomics). Then autograd through
    attention() at Skv = 600 launches the forward and the backward once
    each and matches the twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate(FLASH_CASES):
        q, k, v, mask = _case(i, b, sq, skv, h, d, lengths, dev)
        do = torch.from_numpy(np.random.RandomState(200 + i).standard_normal(
            (b, sq, h, d)).astype(np.float32)).to(dev)
        o, lse = A.flash_attention_fwd(q, k, v, mask, causal)
        want = A.flash_attention_bwd_reference(q, k, v, mask, o, lse, do,
                                               causal)
        before = A.flash_attention_bwd.launches
        got = A.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
        torch.cuda.synchronize()
        assert A.flash_attention_bwd.launches == before + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
        again = A.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
        assert all(torch.equal(a, g) for a, g in zip(again, got))
        bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o16, lse16 = A.flash_attention_fwd(bq, bk, bv, mask, causal)
        got16 = A.flash_attention_bwd(bq, bk, bv, mask, o16, lse16, bdo,
                                      causal)
        _assert_flash_bwd_bf16(got16, bq, bk, bv, mask, o16, lse16, bdo,
                               causal)
        again16 = A.flash_attention_bwd(bq, bk, bv, mask, o16, lse16, bdo,
                                        causal)
        assert all(torch.equal(a, g) for a, g in zip(again16, got16))
    # GPT-2's layout: q/k/v as views of one fused [B,S,3,H,D] projection,
    # read in place through its strides; dq/dk/dv come back dense
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(2, 600, 3, 4, 64, device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        mask = torch.ones(2, 600, dtype=torch.int32, device=dev)
        mask[1, :77] = 0
        do = torch.randn(2, 600, 4, 64, device=dev).to(dtype)
        o, lse = A.flash_attention_fwd(q, k, v, mask, True)
        got = A.flash_attention_bwd(q, k, v, mask, o, lse, do, True)
        if dtype == torch.float32:
            want = A.flash_attention_bwd_reference(q, k, v, mask, o, lse, do,
                                                   True)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
        else:
            _assert_flash_bwd_bf16(got, q, k, v, mask, o, lse, do, True)
    q, k, v, mask = _case(13, 2, 40, 600, 4, 64, [600, 333], dev)
    do = torch.randn(2, 40, 4, 64, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = A.flash_attention_fwd.launches, A.flash_attention_bwd.launches
    (A.attention(*leaves, kv_mask=mask) * do).sum().backward()
    torch.cuda.synchronize()
    assert A.flash_attention_fwd.launches == fwd + 1
    assert A.flash_attention_bwd.launches == bwd + 1
    o, lse = A.flash_attention_fwd_reference(q, k, v, mask)
    want = A.flash_attention_bwd_reference(q, k, v, mask, o, lse, do)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, atol=2e-5, rtol=1e-5)


def test_chip_smoke_exits_nonzero_without_a_card():
    """Without a card chip_smoke.py exits non-zero and prints no result
    line (on a card it is run on its own, not from the tests)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: run python3 chip_smoke.py instead")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda.is_available() is False" in proc.stderr
