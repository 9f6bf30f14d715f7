"""Latent diffusion's kernels on the card: B1 and B2 at head dim 160, and
the UNet at Stable Diffusion v1's widths.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_diffusion_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- B1 and B2 at head dim 160 (the UNet's 1280-wide level over 8 heads):
  the middle block's 64 x 64 and 64 x 32 (B2's one-block route), level
  2's 256 x 256 and 256 x 32 (B2's route 2: the LSE pass, the pre-pass,
  the dK/dV and dQ passes), a ragged mask with a fully masked row, causal,
  f32 and bf16, against the plain twins on the same inputs: f32 within
  2e-5 (the backward 2e-5 + 1e-5 |g|), bf16 within the tensor-core bounds
  of tests/test_torch_kernels.py (1e-5 + 2^-8 |x| + 2.5 x 2^-8 R). The
  flash kernels share the templates, so B3-B5 are held at 160 too.
- One UNet call at SD v1 widths (320 channels, mult 1/2/4/4, 2 res blocks,
  attention at levels 0-2, 8 heads, 768-wide context; 64 x 64 latents,
  2 images) in f32 through the kernels against --use_flash_attention=false:
  each launch counted (B1: 16 cross-attentions, level 2's 5 and the
  middle block's self-attention; B3: levels 0 and 1's 10 self-attentions),
  and the noise prediction within 1e-3 of its largest magnitude (each
  f32 attention within 2e-5; 32 of them through GroupNorm-ed residual
  blocks). TF32 is off, as in chip_smoke.py: with cuDNN's TF32
  convolutions the attention paths' 1e-6 differences move TF32 roundings
  and the two runs part by 1.2e-3 of the output (this test on an NVIDIA
  H100 80GB HBM3, 700.00 W).
"""

import numpy as np
import pytest
import torch

from easynlp_tpu_torch.ops import attention as A
from test_torch_kernels import (
    _assert_bwd_bf16,
    _assert_flash_bwd_bf16,
    _assert_fwd_bf16,
    _case,
)

pytestmark = pytest.mark.gpu

SD_V1_UNET = dict(model_channels=320, channel_mult=(1, 2, 4, 4),
                  num_res_blocks=2, attention_levels=(0, 1, 2), num_heads=8,
                  context_dim=768, in_channels=4, out_channels=4,
                  vae_channel_mult=(1, 2, 4, 4))
UNET_RTOL = 1e-3

D160_CASES = [  # B, Sq, Skv, H, D, per-row key lengths, causal
    (2, 64, 64, 8, 160, [64, 64], False),     # the middle block, route 1
    (2, 64, 32, 8, 160, [32, 32], False),     # its cross-attention
    (2, 256, 256, 8, 160, [256, 256], False),  # level 2, route 2
    (2, 256, 32, 8, 160, [32, 32], False),    # level 2's cross-attention
    (3, 100, 120, 2, 160, [120, 57, 0], False),  # ragged, a masked row
    (2, 200, 300, 2, 152, [300, 11], True),   # causal Sq != Skv, D 152
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def test_short_kernels_at_head_dim_160_match_plain_twins():
    _need_card()
    dev = torch.device("cuda")
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate(D160_CASES):
        q, k, v, mask = _case(300 + i, b, sq, skv, h, d, lengths, dev)
        do = torch.from_numpy(np.random.RandomState(400 + i).standard_normal(
            (b, sq, h, d)).astype(np.float32)).to(dev)
        before = (A.short_attention_fwd.launches,
                  A.short_attention_bwd.launches)
        o = A.short_attention_fwd(q, k, v, mask, causal)
        torch.testing.assert_close(
            o, A.short_attention_fwd_reference(q, k, v, mask, causal),
            atol=2e-5, rtol=0)
        got = A.short_attention_bwd(q, k, v, mask, o, do, causal)
        want = A.short_attention_bwd_reference(q, k, v, mask, o, do, causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
        bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o16 = A.short_attention_fwd(bq, bk, bv, mask, causal)
        _assert_fwd_bf16(o16, bq, bk, bv, mask, causal)
        got16 = A.short_attention_bwd(bq, bk, bv, mask, o16, bdo, causal)
        _assert_bwd_bf16(got16, bq, bk, bv, mask, o16, bdo, causal)
        again = A.short_attention_bwd(bq, bk, bv, mask, o16, bdo, causal)
        assert all(torch.equal(a, g) for a, g in zip(again, got16))
        torch.cuda.synchronize()
        assert (A.short_attention_fwd.launches,
                A.short_attention_bwd.launches) == (before[0] + 2,
                                                    before[1] + 3)


def test_flash_kernels_at_head_dim_160_match_plain_twins():
    _need_card()
    dev = torch.device("cuda")
    for i, (b, sq, skv, h, d, lengths, causal) in enumerate([
            (2, 600, 600, 2, 160, [600, 333], False),
            (2, 130, 700, 2, 160, [700, 0], True)]):
        q, k, v, mask = _case(500 + i, b, sq, skv, h, d, lengths, dev)
        do = torch.randn(b, sq, h, d, device=dev)
        o, lse = A.flash_attention_fwd(q, k, v, mask, causal)
        want_o, want_lse = A.flash_attention_fwd_reference(q, k, v, mask,
                                                           causal)
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
        got = A.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
        want = A.flash_attention_bwd_reference(q, k, v, mask, o, want_lse,
                                               do, causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
        bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o16, lse16 = A.flash_attention_fwd(bq, bk, bv, mask, causal)
        _assert_fwd_bf16(o16, bq, bk, bv, mask, causal)
        got16 = A.flash_attention_bwd(bq, bk, bv, mask, o16, lse16, bdo,
                                      causal)
        _, ref_lse = A.flash_attention_fwd_reference(
            bq.float(), bk.float(), bv.float(), mask, causal)
        _assert_flash_bwd_bf16(got16, bq, bk, bv, mask, o16, ref_lse, bdo,
                               causal)


def test_full_width_unet_through_the_kernels():
    _need_card()
    from types import SimpleNamespace

    from easynlp_tpu_torch.modelzoo.models.latent_diffusion.autoencoder \
        import init_module_weights
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion.unet import (
        UNetModel)
    unet = UNetModel(SimpleNamespace(**SD_V1_UNET), device="cuda")
    init_module_weights(unet, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 4, 64, 64), generator=g, device="cuda")
    context = torch.randn((2, 32, 768), generator=g, device="cuda")
    t = torch.tensor([999, 500], device="cuda")
    out = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            A.short_attention_fwd.launches = 0
            A.flash_attention_fwd.launches = 0
            with torch.inference_mode():
                out[use_kernel] = unet(x, t, context)
            launches = (A.short_attention_fwd.launches,
                        A.flash_attention_fwd.launches)
            assert launches == ((22, 10) if use_kernel else (0, 0))
    finally:
        A.set_kernel_override(None)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert torch.isfinite(out[True]).all()
    scale = out[False].abs().max().item()
    assert (out[True] - out[False]).abs().max().item() <= UNET_RTOL * scale
