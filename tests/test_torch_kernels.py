"""The port's kernel build and the CUDA kernel itself.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest
The build tests run anywhere (a stand-in script plays nvcc); the kernel test
is marked `gpu` and skips itself where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_twin():
    """The CUDA kernel against its plain twin on the card: f32 within 2e-5
    (the JAX short kernel's bound against its reference); bf16 within 1.5e-2
    of the f32 twin on the same bf16 inputs (the kernel computes in f32 and
    rounds only its output: half an ulp of |o| < 4 is 2^-7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    cases = [  # B, Sq, Skv, H, D, per-row key lengths, causal
        (2, 40, 40, 3, 16, [0, 33], False),     # fully masked row
        (2, 1, 24, 2, 64, [20, 24], True),      # decode shape
        (2, 37, 40, 2, 64, [40, 11], True),     # Sq != Skv, ragged
        (3, 70, 130, 2, 128, [130, 65, 1], False),
        (2, 16, 16, 2, 40, [16, 9], False),     # D not a power of two
        (4, 128, 128, 12, 64, [128, 100, 57, 1], False)]
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate(cases):
        q, k, v, mask = _case(i, b, sq, skv, h, d, lengths, dev)
        want = A.short_attention_fwd_reference(q, k, v, mask, causal)
        before = A.short_attention_fwd.launches
        got = A.short_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        assert A.short_attention_fwd.launches == before + 1
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
        got16 = A.short_attention_fwd(bq, bk, bv, mask, causal)
        want16 = A.short_attention_fwd_reference(
            bq.float(), bk.float(), bv.float(), mask, causal)
        assert got16.dtype == torch.bfloat16
        torch.testing.assert_close(got16.float(), want16, atol=1.5e-2,
                                   rtol=0)
    # heads-major input, [1,Skv] mask: read in place through strides
    q, k, v, mask = _case(9, 2, 48, 48, 4, 64, [41], dev)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = A.attention(qh, kh, vh, kv_mask=mask, layout="bhsd")
    assert got.is_contiguous()
    want = A.short_attention_fwd_reference(q, k, v, mask).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


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
