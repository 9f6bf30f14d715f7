"""Slice 12's paths on the card, and the repairs of ROADMAP C28 and C29.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_clip_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- The ViT at Chinese-CLIP ViT-B/16 widths (224 px, patch 16: 197 keys, 12
  layers, 768 wide, quick_gelu), a bf16 forward and backward of 8 images
  through the kernels (B1, and B2's route past 128 keys) against
  --use_flash_attention=false: the pooled output within 5e-2, the
  gradients' relative rms gap (all parameters together) within 1e-2 (the
  bf16 bounds chip_smoke holds the encoder apps and MegatronBERT to).
- The captioner's greedy captions (ViT + 2-layer GPT-2, f32) on the card
  equal the CPU's token for token.
- T5-base (8 x 512 sources, 64-token targets) and Kangaroo (32 x 128, the
  phase-14 fixture), each trained 4 bf16 steps twice through the CLI with
  the kernels (chip_diag/determinism.py): every loss and gradient norm,
  and every gradient the optimizer receives, bit for bit.
"""

import os
import sys
import tempfile

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_B16 = dict(image_size=224, patch_size=16, hidden_size=768,
               num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, hidden_act="quick_gelu",
               layer_norm_eps=1e-5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def test_vit_b16_forward_and_backward_through_the_kernels():
    _need_card()
    from easynlp_tpu_torch.modelzoo.models.clip import (CLIPVisionConfig,
                                                        ViTEncoder)
    vit = ViTEncoder(CLIPVisionConfig(**VIT_B16), dtype=torch.bfloat16,
                     device="cuda")
    vit.init_weights(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    pixels = torch.randint(0, 256, (8, 224, 224, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    target = torch.randn((8, 768), generator=g, device="cuda")
    out = {}
    try:
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            A.short_attention_fwd.launches = 0
            A.short_attention_bwd.launches = 0
            vit.zero_grad()
            pooled = vit(pixels)["pooler_output"]
            (pooled.float() * target).sum().backward()
            out[use_kernel] = (pooled.float(), {
                n: p.grad.float().clone() for n, p in vit.named_parameters()})
            launches = (A.short_attention_fwd.launches,
                        A.short_attention_bwd.launches)
            assert launches == ((12, 12) if use_kernel else (0, 0))
    finally:
        A.set_kernel_override(None)
    assert (out[True][0] - out[False][0]).abs().max() <= 5e-2
    got = torch.cat([g.reshape(-1) for g in out[True][1].values()])
    want = torch.cat([g.reshape(-1) for g in out[False][1].values()])
    assert torch.isfinite(got).all()
    assert (got - want).norm() / want.norm() <= 1e-2


def test_captions_on_the_card_equal_the_cpus():
    _need_card()
    from easynlp_tpu_torch.appzoo.image2text_generation.model import (
        CLIPGPTImageTextGeneration, CLIPGPTImageTextModule, I2TConfig)
    cfg = I2TConfig(vision_config=dict(VIT_B16, image_size=64,
                                       num_hidden_layers=2),
                    gpt_config=dict(vocab_size=500, n_positions=128,
                                    n_embd=128, n_layer=2, n_head=4,
                                    resid_pdrop=0.0, embd_pdrop=0.0,
                                    attn_pdrop=0.0))
    module = CLIPGPTImageTextModule(cfg)
    module.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # a head that depends on the image
        for p in module.gpt.parameters():
            p.mul_(3.0)
    pixels = torch.rand((4, 64, 64, 3), generator=torch.Generator()
                        .manual_seed(1))
    ids = {}
    for device in ("cpu", "cuda"):
        app = CLIPGPTImageTextGeneration(module.to(device).eval(), cfg,
                                         device)
        for beams in (1, 4):
            ids[device, beams] = app.generate(pixels, max_length=12,
                                              num_beams=beams,
                                              bos_token_id=1,
                                              eos_token_id=2).cpu()
    for beams in (1, 4):
        assert torch.equal(ids["cuda", beams], ids["cpu", beams])


@pytest.fixture(scope="module")
def determinism():
    sys.path.insert(0, os.path.join(REPO, "chip_diag"))
    sys.path.insert(0, REPO)
    import determinism as D
    return D


@pytest.mark.parametrize("model", ["t5", "kangaroo"])
def test_training_repeats_bit_for_bit(determinism, model):
    """ROADMAP C28 (T5's relative-position table) and C29 (Kangaroo's
    entity gathers and sample positions)."""
    _need_card()
    D = determinism
    work = tempfile.mkdtemp(prefix="test_determinism_")
    if model == "t5":
        runs, differ = D.t5(work)
    else:
        cjk = D.C.make_model_dir(torch, os.path.join(work, D.C.MODEL_DIR),
                                 D.SEED)
        D.C.make_mlm_model_dir(torch, work, D.SEED)
        runs, differ = D.kangaroo(work, cjk)
    assert len(runs[0]) == 4
    assert runs[0] == runs[1] and differ == []
