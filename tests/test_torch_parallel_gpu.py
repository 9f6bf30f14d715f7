"""The port's device-parallel layer on the card (marked gpu: they skip
where torch.cuda.is_available() is False). No JAX: run on the card's
machine with

    python -m pytest tests/test_torch_parallel_gpu.py -m gpu --noconftest

- two `gloo` ranks on cuda:0 run the ring over sequence=2 at 4 x 512 (f32):
  every hop launches B3 forward and B4/B5 backward, and the result equals
  one rank's attention() (the short kernels) within the f32 kernels'
  bounds, a fully masked row included (ROADMAP C1);
- `--mesh=dp=1` on one process starts an NCCL group of one rank, and a
  BERT training step through the Trainer equals the step without a mesh
  bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_workers import run_ranks  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_ring_on_two_gloo_ranks_launches_b3_b4_b5(card, tmp_path):
    from easynlp_tpu_torch.ops import attention as A
    rng = np.random.RandomState(0)
    case = {n: rng.randn(4, 512, 4, 64).astype(np.float32)
            for n in ("q", "k", "v", "do")}
    mask = np.ones((4, 512), np.int32)
    mask[1, 300:] = 0
    mask[2] = 0
    case.update(mask=mask, causal=False)
    res = run_ranks("ring", 2, str(tmp_path), [case], mesh={"sequence": 2},
                    device="cuda", timeout=300)
    for r in res:
        assert r[-1]["launches"]["flash_attention_fwd"] == 2
        assert r[-1]["launches"]["flash_attention_bwd"] == 2
    got = {k: np.concatenate([r[0][k].numpy() for r in res], 1)
           for k in ("out", "dq", "dk", "dv")}
    dev = torch.device("cuda")
    q, k, v = (torch.tensor(case[n], device=dev, requires_grad=True)
               for n in ("q", "k", "v"))
    o = A.attention(q, k, v, kv_mask=torch.tensor(mask, device=dev))
    o.backward(torch.tensor(case["do"], device=dev))
    np.testing.assert_allclose(got["out"], o.detach().cpu().numpy(),
                               atol=2e-5)
    for name, g in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        g = g.cpu().numpy()
        assert np.all(np.abs(got[name] - g) <= 2e-5 + 1e-5 * np.abs(g)), \
            name


def test_mesh_dp1_nccl_step_equals_no_mesh(card):
    import torch.distributed as dist

    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, SequenceClassificationModule)
    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from easynlp_tpu_torch.parallel import mesh as M
    from easynlp_tpu_torch.utils.arguments import parse_args

    class Rows:
        def __len__(self):
            return 16

    dev = torch.device("cuda", 0)
    cfg = BertConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    g = torch.Generator().manual_seed(0)
    batch = {"input_ids": torch.randint(5, 1000, (16, 64), generator=g),
             "attention_mask": torch.ones(16, 64, dtype=torch.int32),
             "token_type_ids": torch.zeros(16, 64, dtype=torch.int32),
             "label_ids": torch.randint(0, 2, (16,), generator=g)}
    batch = {k: v.to(dev) for k, v in batch.items()}

    def step(mesh_spec):
        args = parse_args(args_list=["--dtype=float32", "--device=cuda",
                                     "--micro_batch_size=16"] + (
            ["--mesh=" + mesh_spec] if mesh_spec else []))
        if mesh_spec:
            M.init_distributed(args, dev)
            M.set_global_mesh(M.build_mesh({"data": 1}, "cuda"))
            assert dist.get_backend() == "nccl"
        module = SequenceClassificationModule(cfg, device=dev)
        module.init_weights(torch.Generator(device=dev).manual_seed(0))
        trainer = Trainer(SequenceClassification(module, cfg, dev),
                          Rows(), args=args)
        _, values = trainer._train_step(batch)
        return values.cpu(), [p.detach().cpu() for p in module.parameters()]

    try:
        plain = step(None)
        meshed = step("dp=1")
    finally:
        M.destroy()
    assert torch.equal(plain[0], meshed[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[1], meshed[1]))
