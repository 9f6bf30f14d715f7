"""ARTIST's attention shapes on the card, kernels against their plain twins,
and ARTIST's greedy image codes through the kernels against the plain
path.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_artist_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- At ARTIST-base's shapes (12 heads of 64): B1 over the training
  sequence, 8 x 288 causal, each row's text padded inside its first 32
  keys (8-32 real tokens, then 256 codes); a decode step, 8 x 1 x 288,
  over a cache with those holes; B2 over the training sequence (route 2
  in bf16: the LSE pass, then B4/B5's passes); B1 at the enable_vqgan
  prefill, 8 x 257 causal. f32 within 2e-5 of the twins (the backward
  2e-5 + 1e-5 |g|), bf16 within the tensor-core bounds of
  tests/test_torch_kernels.py.
- A reduced ARTIST (the f16 VQGAN's five levels at width 32, a 1024-code
  codebook, a 4-layer GPT of width 256 over 4 heads of 64; 32 text tokens
  and 256 codes, so the full width's 288 keys) in f32 with TF32 off:
  greedy codes for 4 prompts through the kernels (one B1 launch a layer
  for the prefill and for each decode step) against
  --use_flash_attention=false, code for code, or parting only where the
  plain path's top-2 margin is at most chip_smoke.SERVE_F32_TIE (an f32
  tie, which the kernels' 1e-6 differences may break either way).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from easynlp_tpu_torch.ops import attention as A
from test_torch_kernels import _assert_bwd_bf16, _assert_fwd_bf16

pytestmark = pytest.mark.gpu

TEXT, CODES, H, D = 32, 256, 12, 64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def artist_mask(rng, b, text=TEXT, codes=CODES):
    """[B, text + codes] bool: each row's 8-32 real text tokens, its
    padding up to `text`, then every code real."""
    mask = np.ones((b, text + codes), bool)
    for i, n in enumerate(rng.randint(8, text + 1, b)):
        mask[i, n:text] = False
    return mask


def _qkv(rng, b, sq, skv, dev):
    return tuple(torch.from_numpy(rng.standard_normal((b, s, H, D)).astype(
        np.float32)).to(dev) for s in (sq, skv, skv))


def test_artist_shapes_match_plain_twins():
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    s = TEXT + CODES
    train = artist_mask(rng, 8)
    cases = [  # (name, Sq, mask, causal, backward)
        ("train", s, train, True, True),
        ("decode", 1, train, False, False),
        ("vqgan-prefill", CODES + 1, np.ones((8, CODES + 1), bool), True,
         False)]
    for name, sq, mask_np, causal, backward in cases:
        q, k, v = _qkv(rng, 8, sq, mask_np.shape[1], dev)
        mask = torch.from_numpy(mask_np).to(dev)
        o = A.short_attention_fwd(q, k, v, mask, causal)
        torch.testing.assert_close(
            o, A.short_attention_fwd_reference(q, k, v, mask, causal),
            atol=2e-5, rtol=0, msg=name)
        bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
        o16 = A.short_attention_fwd(bq, bk, bv, mask, causal)
        _assert_fwd_bf16(o16, bq, bk, bv, mask, causal)
        if not backward:
            continue
        do = torch.from_numpy(rng.standard_normal(q.shape).astype(
            np.float32)).to(dev)
        got = A.short_attention_bwd(q, k, v, mask, o, do, causal)
        want = A.short_attention_bwd_reference(q, k, v, mask, o, do, causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
        bdo = do.to(torch.bfloat16)
        got16 = A.short_attention_bwd(bq, bk, bv, mask, o16, bdo, causal)
        _assert_bwd_bf16(got16, bq, bk, bv, mask, o16, bdo, causal)


REDUCED = dict(text_vocab_size=21128, image_vocab_size=1024,
               image_token_length=CODES, text_length=TEXT, codebook_dim=64,
               vq_channels=32, vq_channel_mult=(1, 1, 2, 2, 4),
               vq_num_res_blocks=1,
               gpt_config=dict(n_positions=TEXT + CODES, n_embd=256,
                               n_layer=4, n_head=4, resid_pdrop=0.0,
                               embd_pdrop=0.0, attn_pdrop=0.0))


def test_greedy_codes_through_the_kernels_match_plain():
    _need_card()
    from easynlp_tpu_torch.appzoo.text2image_generation.model import (
        TextImageGeneration)
    from easynlp_tpu_torch.modelzoo.models.artist import (
        ARTISTConfig, ARTISTModel)
    cfg = ARTISTConfig(**REDUCED)
    module = ARTISTModel(cfg, device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    app = TextImageGeneration(module.eval(), cfg, "cuda")
    rng = np.random.RandomState(1)
    mask = artist_mask(rng, 4, codes=0).astype(np.int32)
    ids = np.where(mask == 1, rng.randint(1000, 20000, mask.shape), 0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    codes = {}
    try:
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            A.short_attention_fwd.launches = 0
            codes[use_kernel] = app.generate(ids, mask, do_sample=False).cpu()
            assert A.short_attention_fwd.launches == (
                cfg.gpt_config.n_layer * CODES if use_kernel else 0)
        for i in range(4):
            a, b = codes[True][i].tolist(), codes[False][i].tolist()
            j = chip_smoke._first_divergence(a, b)
            if j is None:
                continue
            # the plain path's top-2 margin over the image codes at step j
            seq = torch.cat([torch.from_numpy(ids[i:i + 1]).cuda(),
                             codes[False][i:i + 1, :j].cuda()
                             + cfg.text_vocab_size], dim=1)
            with torch.inference_mode():
                logits = module.lm_step(seq, attention_mask=torch.cat([
                    torch.from_numpy(mask[i:i + 1]).cuda(),
                    torch.ones((1, j), dtype=torch.int32, device="cuda")],
                    dim=1))["logits"][0, -1, cfg.text_vocab_size:]
            top2 = logits.topk(2).values
            assert (top2[0] - top2[1]).item() <= chip_smoke.SERVE_F32_TIE, \
                (i, j)
    finally:
        A.set_kernel_override(None)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert len(np.unique(codes[True].numpy())) > 16
