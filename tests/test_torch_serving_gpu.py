"""The serving path of the PyTorch port on the card, through the kernels:
continuous batching of a small GPT-2 (2 layers, width 128, head dim 64)
over a 640-slot window, so each admit's prefill runs the short forward (B1)
over its 64-token bucket and each decode step the flash forward (B3) over
the window, with the chunk's tokens read back through pinned memory.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_serving_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

Bounds: in f32 (the kernels' CUDA-core routes) the batcher's greedy tokens
equal standalone greedy decoding's over the same window, 4 rows a batch as
the batcher steps them; in bf16 (the tensor cores) every request gets 1..n
valid tokens, each decode chunk launches B3 and each admit B1, and no call
reaches attention_reference.
"""

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu
WINDOW, BUCKET, SLOTS = 640, 64, 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _model(dtype):
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (
        GPT2Config,
        GPT2LMHeadModel,
    )
    config = GPT2Config(vocab_size=512, n_positions=1024, n_embd=128,
                        n_layer=2, n_head=2, resid_pdrop=0.0,
                        embd_pdrop=0.0, attn_pdrop=0.0)
    model = GPT2LMHeadModel(config, dtype=dtype, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return model.eval()


def _work(n=12):
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(5, BUCKET + 1, (n,), generator=g).tolist()
    budgets = torch.randint(4, 40, (n,), generator=g).tolist()
    return [(torch.randint(1, 512, (m,), generator=g).tolist(), b)
            for m, b in zip(lens, budgets)]


def _standalone(model, work):
    """Greedy decoding over a WINDOW-slot cache, SLOTS rows a batch,
    left-padded to BUCKET as the batcher pads."""
    from easynlp_tpu_torch.modelzoo.generation_utils import left_pad
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    prefill, decode = make_gpt2_generation_fns(model, WINDOW)
    out = []
    with torch.inference_mode():
        for s in range(0, len(work), SLOTS):
            group = work[s:s + SLOTS]
            ids, mask = left_pad([p for p, _ in group], 0, length=BUCKET)
            logits, cache = prefill(torch.from_numpy(ids).cuda().long(),
                                    torch.from_numpy(mask).cuda())
            steps = []
            for j in range(max(n for _, n in group)):
                tok = logits.argmax(-1)
                steps.append(tok)
                logits, cache = decode(tok[:, None], cache)
            steps = torch.stack(steps, 1).cpu()
            out += [steps[i, :n].tolist() for i, (_, n) in enumerate(group)]
    return out


def _no_reference(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("the serving path reached attention_reference")
    monkeypatch.setattr(A, "attention_reference", refused)


def test_f32_batcher_matches_standalone_greedy(monkeypatch):
    _need_card()
    from easynlp_tpu_torch.serving import ContinuousBatcher
    model = _model(torch.float32)
    work = _work()
    want = _standalone(model, work)
    _no_reference(monkeypatch)
    b = ContinuousBatcher(model, max_slots=SLOTS, max_length=WINDOW,
                          prompt_buckets=(BUCKET,), pad_token_id=0,
                          chunk_size=8)
    before = (A.short_attention_fwd.launches, A.flash_attention_fwd.launches)
    try:
        handles = [b.submit(p, max_new_tokens=n) for p, n in work]
        got = [h.result(timeout=300) for h in handles]
    finally:
        b.stop()
    assert got == want
    assert A.short_attention_fwd.launches > before[0]
    assert A.flash_attention_fwd.launches > before[1]


def test_bf16_server_runs_the_tensor_core_kernels(monkeypatch):
    """bf16 over HTTP: blocking, batch and streamed requests; a sampled
    request gives the same tokens twice; B1 and B3 launch, a multiple of
    the layer count each."""
    _need_card()
    import json
    import urllib.request
    from easynlp_tpu_torch.serving import ContinuousBatcher, GenerationServer
    model = _model(torch.bfloat16)
    _no_reference(monkeypatch)
    b = ContinuousBatcher(model, max_slots=SLOTS, max_length=WINDOW,
                          prompt_buckets=(32, BUCKET), pad_token_id=0,
                          chunk_size=8)
    srv = GenerationServer(b, port=0, default_max_new_tokens=12).start()

    def post(payload):
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % srv.port,
            data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read().decode()
    counts = (A.short_attention_fwd.launches, A.flash_attention_fwd.launches)
    try:
        work = _work(6)
        body = json.loads(post({"prompts": [p for p, _ in work],
                                "max_new_tokens": [n for _, n in work]}))
        for out, (_, n) in zip(body["outputs"], work):
            assert 1 <= len(out) <= n and all(0 <= t < 512 for t in out)
        events = [json.loads(x) for x in post(
            {"prompt_ids": work[0][0], "stream": True}).splitlines()]
        assert events[-1]["done"] is True
        assert [e["token"] for e in events[:-1]] == events[-1]["output_ids"]
        sampled = {"prompt_ids": work[1][0], "do_sample": True,
                   "temperature": 0.8, "top_k": 20, "seed": 5}
        assert post(sampled) == post(sampled)
    finally:
        srv.stop()
    b1 = A.short_attention_fwd.launches - counts[0]
    b3 = A.flash_attention_fwd.launches - counts[1]
    assert b1 > 0 and b3 > 0 and b1 % 2 == 0 and b3 % 2 == 0
