"""GPT-2 generation under a tensor mesh on the card (marked gpu: it skips
where torch.cuda.is_available() is False). No JAX: run on the card's
machine with

    python -m pytest tests/test_torch_tp_gpu.py -m gpu --noconftest

Two `gloo` ranks on cuda:0 (NCCL refuses two ranks on one device) split a
tiny GPT-2 (vocab 96, 64 wide, 2 layers, 4 heads: 2 a rank) with
parallelize and run generate() greedy and with 3 beams over four
left-padded prompts: both ranks return the tokens of the same weights in
this one process on the card, and each rank's attention ran on B1 (the
short forward kernel: prompts and caches stay under 512 keys).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as W  # noqa: E402

pytestmark = pytest.mark.gpu

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _payload():
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    model = GPT2LMHeadModel(GPT2Config(**TINY))
    model.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(3)
    ids = rs.randint(1, 95, (4, 12)).astype(np.int64)
    mask = np.ones((4, 12), np.int64)
    mask[1, :4] = 0
    mask[3, :7] = 0
    ids[mask == 0] = 0
    gen = {"greedy": (32, 0, dict(ids=ids, mask=mask, pad_token_id=0)),
           "beam": (32, 0, dict(ids=ids, mask=mask, num_beams=3,
                                pad_token_id=0, eos_token_id=95))}
    return dict(config=TINY, state=state, generate=gen)


def test_generate_on_two_gloo_ranks_equals_one_process(card, tmp_path):
    payload = _payload()
    ranks = W.run_ranks("gpt2_tp_decoding", 2, str(tmp_path), payload,
                        mesh={"tensor": 2}, device="cuda", timeout=300)
    W.DEVICE = torch.device("cuda", 0)
    try:
        one = W.gpt2_tp_decoding(payload)
    finally:
        W.DEVICE = torch.device("cpu")
    for r in ranks:
        assert r["launches"]["short_attention_fwd"] > 0
        for name in ("greedy", "beam"):
            np.testing.assert_array_equal(r[name].numpy(),
                                          one[name].numpy())
