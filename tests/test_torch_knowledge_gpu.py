"""The knowledge models on the card, through the kernels.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_knowledge_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- Kangaroo (hidden 128, 2 heads, layer types sim, norm, mix; 4 x 64 text,
  4 x 2 x 3 sample rows of 64, a third of the entity slots empty): the
  forward through the kernels (B1 for the text and the sample encoding;
  the entity attention's head dim 3 takes the plain path) against
  --use_flash_attention=false on the card, f32 within 1e-4 on logits and
  cos_score, 1e-5 on the loss, and the fully masked sample rows' [CLS]
  states finite; the kernels launched once a text layer and once a
  sample layer.
- MegatronBERT (pre-LN, width 128, 2 heads, 3 layers) at 4 x 300, bf16:
  B1 and B2's route 2 (past 128 keys: the LSE pass, then B4/B5's passes)
  once a layer; the loss within 5e-2 and every gradient finite against the
  plain path.
- K-BERT with a visible matrix launches no kernel.
- LoRA under --remat=full and selective: the adapters' gradients bit for
  bit those of --remat=none through the kernels (the recompute reads the
  merged weights through their parametrizations).
- AutoModel.from_config and from_pretrained put the module on the card
  unless asked for the CPU.
"""

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu
WIDTHS = dict(vocab_size=300, hidden_size=128, num_attention_heads=2,
              intermediate_size=256, max_position_embeddings=320,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _launches():
    return (A.short_attention_fwd.launches, A.short_attention_bwd.launches)


def _kangaroo_inputs():
    g = torch.Generator().manual_seed(5)
    b, s, n, k, ss = 4, 64, 2, 3, 64
    mask = (torch.arange(s)[None] < torch.tensor([64, 30, 48, 12])[:, None])
    ids = torch.randint(4, 300, (b, s), generator=g) * mask
    ep = torch.zeros(b, s, dtype=torch.int64)
    ep[0, 2:5], ep[0, 9:11], ep[1, 4:6], ep[2, 1:3] = 1, 2, 1, 2
    linked = torch.tensor([2, 1, 2, 0])  # row 3 links no entity
    slot_on = torch.arange(n)[None] < linked[:, None]
    slot_on[2, 0] = False                  # an empty slot before a full one
    lengths = torch.randint(3, ss + 1, (b, n, k), generator=g)
    smask = (torch.arange(ss) < lengths[..., None]) & slot_on[..., None, None]
    tok = torch.randint(4, 300, (b, n, k, ss), generator=g) * smask
    inputs = dict(input_ids=ids, attention_mask=mask.int(),
                  entities_position=ep, ent_mask=(ep != 0).int(),
                  sample_token_id=tok, sample_position_id=torch.arange(ss)
                  .expand(b, n, k, ss) * smask, sample_mask=smask.int(),
                  concept_emb=torch.randn(b, n, 10, generator=g))
    labels = torch.where(mask & (torch.rand(b, s, generator=g) < 0.3), ids,
                         -100)
    return ({key: v.cuda() for key, v in inputs.items()},
            {"label_ids": labels.cuda()})


def test_kangaroo_through_the_kernels():
    _need_card()
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.kangaroo import KangarooConfig
    config = KangarooConfig(num_hidden_layers=3,
                            layer_types=["sim", "norm", "mix"], ent_size=12,
                            ent_heads=4, concept_size=10, ent_num=2,
                            sample_num=3, **WIDTHS)
    module = KangarooLanguageModeling.build_module(config, device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    module.eval()
    inputs, batch = _kangaroo_inputs()
    outs = {}
    for override in (None, False):
        A.set_kernel_override(override)
        try:
            before = _launches()
            with torch.no_grad():
                out = module(**inputs)
                loss = KangarooLanguageModeling.loss_fn(out, batch)["loss"]
                cls = module.kangaroo.encode_samples(
                    inputs["sample_token_id"], inputs["sample_position_id"],
                    inputs["sample_mask"])
            used = tuple(a - b for a, b in zip(_launches(), before))
        finally:
            A.set_kernel_override(None)
        outs[override] = (out, loss, cls, used)
    (k, lk, ck, used), (p, lp, cp, plain) = outs[None], outs[False]
    # 3 text layers + 1 sample layer, then the sample layer again
    assert used == (5, 0) and plain == (0, 0)
    for key in ("logits", "cos_score"):
        torch.testing.assert_close(k[key], p[key], atol=1e-4, rtol=0)
    torch.testing.assert_close(lk, lp, atol=1e-5, rtol=0)
    empty = inputs["sample_mask"].sum(-1) == 0
    assert empty.any() and torch.isfinite(ck[empty]).all()
    torch.testing.assert_close(ck, cp, atol=1e-4, rtol=0)


def test_megatron_route_2_through_the_kernels():
    _need_card()
    from easynlp_tpu_torch.modelzoo.models.megatron_bert import (
        MegatronBertConfig, MegatronBertModel)
    config = MegatronBertConfig(num_hidden_layers=3, **WIDTHS)
    module = MegatronBertModel(config, dtype=torch.bfloat16, device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator().manual_seed(2)
    mask = (torch.arange(300)[None] < torch.tensor([300, 140, 257, 200])
            [:, None]).int()
    ids = torch.randint(4, 300, (4, 300), generator=g) * mask
    w = torch.linspace(-1, 1, 128, device="cuda")
    runs = {}
    for override in (None, False):
        A.set_kernel_override(override)
        try:
            module.zero_grad(set_to_none=True)
            before = _launches()
            out = module(ids.cuda(), mask.cuda())
            loss = (out["last_hidden_state"].float() * w).mean() \
                + (out["pooler_output"].float() * w).mean()
            loss.backward()
            used = tuple(a - b for a, b in zip(_launches(), before))
        finally:
            A.set_kernel_override(None)
        runs[override] = (float(loss.detach()), used, [p.grad for p in
                                              module.parameters()])
    assert runs[None][1] == (3, 3) and runs[False][1] == (0, 0)
    assert abs(runs[None][0] - runs[False][0]) < 5e-2
    assert all(torch.isfinite(gr).all() for gr in runs[None][2])


def test_kbert_launches_no_kernel():
    _need_card()
    from easynlp_tpu_torch.modelzoo.models.kbert import (KBertConfig,
                                                         KBertModel)
    module = KBertModel(KBertConfig(num_hidden_layers=2, **WIDTHS),
                        dtype=torch.bfloat16, device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(3))
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(4, 300, (4, 64), generator=g).cuda()
    visible = (torch.rand(4, 64, 64, generator=g) < 0.7).int().cuda()
    before = _launches()
    out = module(ids, visible_matrix=visible)
    out["pooler_output"].float().sum().backward()
    assert _launches() == before
    assert torch.isfinite(out["last_hidden_state"]).all()


def test_lora_under_remat_through_the_kernels():
    _need_card()
    from easynlp_tpu_torch.core.lora_app import LoRAModule
    from easynlp_tpu_torch.modelzoo.lora import lora_init
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    inner = BertModel(BertConfig(num_hidden_layers=2, **WIDTHS),
                      dtype=torch.bfloat16, device="cuda")
    inner.init_weights(torch.Generator(device="cuda").manual_seed(6))
    lora = lora_init(inner, rank=4, targets=("query", "value", "dense"))
    with torch.no_grad():
        for ad in lora.values():
            ad["b"].normal_(0, 0.02)
    module = LoRAModule(inner, lora, 2.0)
    g = torch.Generator().manual_seed(7)
    mask = (torch.arange(128)[None] < torch.tensor([128, 40, 90, 7])
            [:, None]).int().cuda()
    ids = torch.randint(4, 300, (4, 128), generator=g).cuda() * mask
    grads = {}
    for policy in ("none", "full", "selective"):
        set_remat(module, policy)
        module.zero_grad(set_to_none=True)
        out = module(ids, mask)
        (out["last_hidden_state"].float().square().mean()
         + out["pooler_output"].float().mean()).backward()
        grads[policy] = [p.grad.clone() for p in module.lora_a] + \
            [p.grad.clone() for p in module.lora_b]
    for policy in ("full", "selective"):
        assert all(torch.equal(a, b) for a, b in zip(grads[policy],
                                                     grads["none"]))
    assert all(p.grad is None for p in inner.parameters())


def test_auto_model_defaults_to_the_card(tmp_path):
    _need_card()
    from easynlp_tpu_torch.modelzoo.models import auto
    from easynlp_tpu_torch.modelzoo.models.megatron_bert import (
        MegatronBertConfig)
    config = MegatronBertConfig(num_hidden_layers=2, **WIDTHS)
    module = auto.AutoModel.from_config(config)
    assert all(t.is_cuda for t in module.state_dict().values())
    config.save_pretrained(str(tmp_path))
    torch.save({k: v.cpu() for k, v in module.state_dict().items()},
               tmp_path / "pytorch_model.bin")
    loaded = auto.AutoModel.from_pretrained(str(tmp_path))
    assert type(loaded).__name__ == "MegatronBertModel"
    assert all(t.is_cuda for t in loaded.state_dict().values())
