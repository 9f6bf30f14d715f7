"""Slice 10's models on the card, through the kernels.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_seq2seq_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- T5 (d_model 128, d_kv 32, 4 heads, 2 + 2 layers) at 4 x 300 sources and
  24 targets: its cross-attention takes the short kernels unscaled (scale
  1.0), its self-attentions the plain bias path. f32 logits within 1e-4
  and every gradient within 1e-4 of its largest entry against
  --use_flash_attention=false on the card; one forward and one backward
  launch a decoder layer; greedy and 4-beam generation on the card equal
  the CPU's token for token.
- Pegasus (pre-LN, sinusoidal positions) at 2 x 600: the encoder and the
  cross-attention through the flash kernels, the decoder through the short
  ones; the dialogue transformer at head dim 32 through the short kernels;
  f32 logits and gradients against the plain path as above.
"""

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _launches():
    return {w: getattr(A, w).launches for w in (
        "short_attention_fwd", "short_attention_bwd", "flash_attention_fwd",
        "flash_attention_bwd")}


def _batch(b, s, lengths, vocab, seed, pad):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(s)[None] < torch.tensor(lengths)[:, None]).int()
    ids = torch.randint(4, vocab, (b, s), generator=g)
    return torch.where(mask.bool(), ids, pad), mask


def _models():
    from easynlp_tpu_torch.modelzoo.models.bart import (
        BartForConditionalGeneration, PegasusConfig)
    from easynlp_tpu_torch.modelzoo.models.t5 import (
        T5Config, T5ForConditionalGeneration)
    from easynlp_tpu_torch.modelzoo.models.transformer import (
        TransformerConfig, TransformerGeneratorModel)
    t5 = T5ForConditionalGeneration(T5Config(
        vocab_size=300, d_model=128, d_kv=32, d_ff=256, num_layers=2,
        num_heads=4, dropout_rate=0.0))
    pegasus = BartForConditionalGeneration(PegasusConfig(
        vocab_size=300, d_model=128, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256, max_position_embeddings=640,
        dropout=0.0))
    dialogue = TransformerGeneratorModel(TransformerConfig(
        vocab_size=300, embedding_size=128, ffn_size=256, n_layers=2,
        n_heads=4, n_positions=640, dropout=0.0))
    return {"t5": (t5, 300, 24), "pegasus": (pegasus, 600, 16),
            "dialogue": (dialogue, 128, 32)}


@pytest.mark.parametrize("family", ["t5", "pegasus", "dialogue"])
def test_forward_and_backward_through_the_kernels(family):
    _need_card()
    model, src_len, tgt_len = _models()[family]
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.cuda()
    pad = model.config.pad_token_id
    ids, mask = _batch(2, src_len, [src_len, src_len // 2], 300, 1, pad)
    dec, dec_mask = _batch(2, tgt_len, [tgt_len, tgt_len - 5], 300, 2, pad)
    args = [t.cuda() for t in (ids, mask, dec, dec_mask)]
    runs = {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        try:
            before = _launches()
            model.zero_grad()
            logits = model(*args)["logits"]
            loss = logits.float().logsumexp(-1).mean()
            loss.backward()
            torch.cuda.synchronize()
            used = {k: v - before[k] for k, v in _launches().items()}
        finally:
            A.set_kernel_override(None)
        runs[use_kernel] = (logits.detach(), {
            n: p.grad.clone() for n, p in model.named_parameters()}, used)
    layers = 2
    want = {"t5": {"short_attention_fwd": layers,
                   "short_attention_bwd": layers},
            "pegasus": {"short_attention_fwd": layers,
                        "short_attention_bwd": layers,
                        "flash_attention_fwd": 2 * layers,
                        "flash_attention_bwd": 2 * layers},
            "dialogue": {"short_attention_fwd": 3 * layers,
                         "short_attention_bwd": 3 * layers}}[family]
    assert runs[True][2] == dict(dict.fromkeys(runs[True][2], 0), **want)
    assert not any(runs[False][2].values())
    torch.testing.assert_close(runs[True][0], runs[False][0], atol=1e-4,
                               rtol=0)
    for name, g in runs[True][1].items():
        w = runs[False][1][name]
        tol = max(1e-4 * w.abs().max().item(), 1e-6)
        torch.testing.assert_close(g, w, atol=tol, rtol=0, msg=name)


@pytest.mark.parametrize("num_beams", [1, 4])
def test_t5_generation_on_the_card_matches_the_cpu(num_beams):
    """f32: the kernels' cross-attention (scale 1.0) and the cached decode
    give the CPU's tokens, the pad id banned."""
    _need_card()
    from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
        encoder_decoder_generate)
    model, src_len, _ = _models()["t5"]
    model.init_weights(torch.Generator().manual_seed(3))
    ids, mask = _batch(3, src_len, [src_len, 200, 37], 300, 4, 0)
    banned = torch.zeros(300, dtype=torch.bool)
    banned[0] = True
    out = {}
    for device in ("cpu", "cuda"):
        m = model.to(device).eval()
        with torch.inference_mode():
            out[device] = encoder_decoder_generate(
                m, ids.to(device), mask.to(device), max_length=16,
                num_beams=num_beams,
                bad_words_mask=banned.to(device)).cpu()
    assert torch.equal(out["cpu"], out["cuda"])
