"""GPT-2 decoding under a tensor mesh in the PyTorch port, held to the JAX
package on the CPU.

The tiny TP-divisible GPT-2 of tests/test_continuous_tp.py (vocab 96,
n_embd 32, 2 layers, 2 heads), initialised by the JAX package and carried
into the port with state_dict_from_jax. The port's ranks are gloo
processes (tests/torch_parallel_workers.py) that call
parallel/sharding.parallelize and then generate(), DeviceContinuousDecoder
and ContinuousBatcher as a user would; one group of two ranks at tensor=2
and one of four at data=2 x tensor=2, each spawned once. Bounds: greedy,
3-beam and speculative tokens equal to JAX's single-device output
(tests/test_multichip_parity.py:172-258, :385-420) and to one port
process; sampled tokens equal to one port process (the packages' random
streams differ, ROADMAP C4); the device decoder's and the thread batcher's
greedy rows equal to JAX's DeviceContinuousDecoder over the same six
mixed rows (tests/test_continuous_tp.py:55-101) and every row equal to
one port process; logits within 1e-5 of one port process (the
row-parallel sums run in another order); the gathered parameters equal
to the originals bit for bit; every rank returns the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_parallel_workers as W
from easynlp_tpu.modelzoo.generation_utils import generate as jax_generate
from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config as JaxGPT2Config
from easynlp_tpu.modelzoo.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from easynlp_tpu.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns as jax_fns,
)
from easynlp_tpu.parallel.mesh import (build_mesh, get_global_mesh,
                                      set_global_mesh)
from easynlp_tpu.serving import continuous as jax_continuous
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    state_dict_from_jax,
)

TINY = dict(vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
LOGITS_ATOL = 1e-5
EOS = 95


def _inputs():
    rs = np.random.RandomState(7)
    ids = rs.randint(1, 95, (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), np.int64)
    mask[1, :5] = 0
    mask[3, :9] = 0
    ids[mask == 0] = 0
    return ids, mask


def _generate_cases():
    """{name: (max_length, cache_slack, kwargs)} of the generate() calls,
    four rows each so that data=2 splits them."""
    ids, mask = _inputs()
    beam_ids = np.array([[5, 6, 7, 8], [9, 10, 11, 12], [40, 41, 42, 43],
                         [7, 7, 8, 8]], np.int64)
    spec_ids = np.array([[5, 6, 5, 6], [9, 10, 9, 10], [3, 4, 3, 4],
                         [20, 21, 20, 21]], np.int64)
    ones = np.ones((4, 4), np.int64)
    spec = dict(ids=spec_ids, mask=ones, pad_token_id=0, eos_token_id=EOS,
                speculative="prompt_lookup", num_draft_tokens=4)
    return {
        "greedy": (24, 0, dict(ids=ids[:, 8:], mask=mask[:, 8:],
                               eos_token_id=EOS, pad_token_id=0)),
        "sampled": (24, 0, dict(ids=ids[:, 8:], mask=mask[:, 8:],
                                do_sample=True, temperature=0.8, top_k=5,
                                row_seeds=np.array([3, 1, 4, 1]),
                                pad_token_id=0)),
        "beam": (16, 0, dict(ids=beam_ids, mask=ones, num_beams=3,
                             eos_token_id=EOS, pad_token_id=0)),
        "speculative": (20, 5, dict(spec)),
        "speculative_shared": (20, 5, dict(spec, shared=True)),
    }


def _decoder_job():
    """JAX's six mixed rows (tests/test_continuous_tp.py:63-71)."""
    rs = np.random.RandomState(2)
    prompts = [[int(x) for x in rs.randint(1, 95, size=rs.randint(3, 12))]
               for _ in range(6)]
    call = dict(max_new_tokens=14,
                do_sample=[False, True, True, False, True, False],
                temperature=[1.0, 0.8, 1.2, 1.0, 0.6, 1.0],
                top_k=[0, 5, 0, 0, 10, 0],
                top_p=[1.0, 1.0, 0.9, 1.0, 0.95, 1.0],
                seed=[0, 1, 2, 3, 4, 5])
    init = dict(max_slots=2, max_length=48, prompt_bucket=16,
                pad_token_id=0, chunk_size=4)
    return dict(prompts=prompts, call=call, init=init)


def _batcher_job(decoder):
    """The decoder's six requests through the thread batcher."""
    c = decoder["call"]
    requests = [(ids, dict(max_new_tokens=c["max_new_tokens"],
                           do_sample=c["do_sample"][i],
                           temperature=c["temperature"][i],
                           top_k=c["top_k"][i], top_p=c["top_p"][i],
                           seed=c["seed"][i]))
                for i, ids in enumerate(decoder["prompts"])]
    return dict(requests=requests, init=dict(
        max_slots=2, max_length=48, prompt_buckets=(16,), pad_token_id=0,
        chunk_size=4))


@pytest.fixture(scope="module")
def case():
    """The JAX model's outputs on one device, the port's payload and one
    port process's outputs."""
    cfg = JaxGPT2Config(**TINY)
    m = JaxGPT2.from_config(cfg, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = nn.unbox(m.init({"params": rng, "dropout": rng},
                             input_ids=jnp.ones((1, 4), jnp.int32),
                             deterministic=True)["params"])
    state = {"transformer." + k: v.numpy()
             for k, v in state_dict_from_jax(params, cfg).items()}
    ids, mask = _inputs()
    gen = _generate_cases()
    decoder = _decoder_job()
    sampled = gen["sampled"][2]
    refused = {"sampled_unseeded": (24, {k: v for k, v in sampled.items()
                                         if k != "row_seeds"}),
               "beam_sampled": (16, dict(gen["beam"][2], do_sample=True,
                                         row_seeds=np.array([3, 1, 4, 1])))}
    payload = dict(config=TINY, state=state, input_ids=ids,
                   attention_mask=mask, generate=gen, refused=refused,
                   decoder=decoder,
                   batcher=_batcher_job(decoder))
    before = get_global_mesh()
    set_global_mesh(build_mesh({"data": 1}, devices=jax.devices()[:1]))
    want = {}
    try:
        for name, (max_length, slack, kw) in gen.items():
            if name == "sampled":
                continue
            kw = {k: v for k, v in kw.items() if k != "shared"}
            prefill, decode = jax_fns(m, max_length, cache_slack=slack)
            want[name] = np.asarray(jax_generate(
                prefill, decode, params,
                jnp.asarray(kw.pop("ids"), jnp.int32),
                jnp.asarray(kw.pop("mask"), jnp.int32),
                max_length=max_length, **kw))
        dec = jax_continuous.DeviceContinuousDecoder(m, params,
                                                     **decoder["init"])
        want["decoder"] = dec(decoder["prompts"], **decoder["call"])
    finally:
        set_global_mesh(before)
    one = W.gpt2_tp_decoding(payload)
    return dict(payload=payload, want=want, one=one)


@pytest.fixture(scope="module")
def tensor2(case, tmp_path_factory):
    return W.run_ranks("gpt2_tp_decoding", 2,
                       str(tmp_path_factory.mktemp("tp2")), case["payload"],
                       mesh={"tensor": 2}, timeout=120)


@pytest.fixture(scope="module")
def data2_tensor2(case, tmp_path_factory):
    p = dict(case["payload"])
    for key in ("input_ids", "decoder", "batcher"):
        p.pop(key)
    return W.run_ranks("gpt2_tp_decoding", 4,
                       str(tmp_path_factory.mktemp("dp2tp2")), p,
                       mesh={"data": 2, "tensor": 2}, timeout=120)


def _same_on_every_rank(ranks, name):
    for r in ranks[1:]:
        assert np.array_equal(np.asarray(r[name]), np.asarray(ranks[0][name]))
    return ranks[0][name]


def test_gpt2_splits_by_jax_logical_axes(case, tensor2):
    """parallelize(gpt2, tensor=2): c_attn by head inside q|k|v, c_fc by
    columns, both c_proj by rows, wte vocab-parallel (96 rows 48/48);
    full_state gathers the originals bit for bit, and the logits of
    left-padded rows are within 1e-5 of one process's."""
    state = case["payload"]["state"]
    shapes = tensor2[0]["local_shapes"]
    h = "transformer.h.0."
    assert shapes["transformer.wte.weight"] == (48, 32)
    assert shapes[h + "attn.c_attn.weight"] == (32, 48)
    assert shapes[h + "attn.c_attn.bias"] == (48,)
    assert shapes[h + "attn.c_proj.weight"] == (16, 32)
    assert shapes[h + "mlp.c_fc.weight"] == (32, 64)
    assert shapes[h + "mlp.c_proj.weight"] == (64, 32)
    assert shapes[h + "mlp.c_proj.bias"] == (32,)
    for r in tensor2:
        assert set(r["params"]) == set(state)
        for k, v in state.items():
            assert torch.equal(r["params"][k], torch.from_numpy(v)), k
        np.testing.assert_allclose(r["logits"].numpy(),
                                   case["one"]["logits"].numpy(),
                                   atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["greedy", "beam", "speculative",
                                  "speculative_shared"])
@pytest.mark.parametrize("mesh", ["tensor2", "data2_tensor2"])
def test_generate_on_a_mesh_is_token_exact_with_jax(case, request, mesh,
                                                    name):
    """Greedy, 3-beam, per-row and shared-acceptance speculative greedy
    (K 4) under tensor=2 and data=2 x tensor=2 give JAX's single-device
    tokens, one port process's, on every rank."""
    ranks = request.getfixturevalue(mesh)
    got = np.asarray(_same_on_every_rank(ranks, name))
    want = case["want"]["speculative" if name.startswith("speculative")
                        else name]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, case["one"][name].numpy())


@pytest.mark.parametrize("mesh", ["tensor2", "data2_tensor2"])
def test_sampled_generate_on_a_mesh_equals_one_process(case, request, mesh):
    """Sampled generate() with per-row seeds: the same tokens on every rank
    and as one port process, the rows split over data or not."""
    ranks = request.getfixturevalue(mesh)
    got = np.asarray(_same_on_every_rank(ranks, "sampled"))
    np.testing.assert_array_equal(got, case["one"]["sampled"].numpy())


@pytest.mark.parametrize("name", ["sampled_unseeded", "beam_sampled"])
@pytest.mark.parametrize("mesh", ["tensor2", "data2_tensor2"])
def test_sampling_without_row_streams_is_refused_on_a_mesh(request, mesh,
                                                           name):
    """Sampling from a generator (no row_seeds, or beam sampling) draws
    from each rank's own stream, which tensor ranks do not share and data
    ranks restart on their block of rows: every rank refuses it."""
    for r in request.getfixturevalue(mesh):
        assert isinstance(r[name], str) and "row_seeds" in r[name], r[name]


def test_device_decoder_under_tensor2_is_token_exact(case, tensor2):
    """DeviceContinuousDecoder over JAX's six mixed rows at tensor=2: the
    greedy rows equal JAX's, every row equals one port process's."""
    got = _same_on_every_rank(tensor2, "decoder")
    assert got == case["one"]["decoder"]
    call = case["payload"]["decoder"]["call"]
    for i, sampled in enumerate(call["do_sample"]):
        if not sampled:
            assert got[i] == case["want"]["decoder"][i]


def test_thread_batcher_under_tensor2_is_token_exact(case, tensor2):
    """ContinuousBatcher at tensor=2: rank 0 takes the submits and sends
    its plans, rank 1 replays them; the outputs equal the device decoder's
    in one process (greedy rows also JAX's), and both ranks moved the same
    plan bytes."""
    lead, follower = tensor2
    assert lead["batcher"] == case["one"]["decoder"]
    assert "batcher" not in follower
    assert lead["plan_bytes"] == follower["plan_bytes"] > 0


def test_a_failing_follower_fails_the_leads_requests(case, tmp_path):
    """A follower that fails at its second chunk ends its process; the
    lead's pending requests fail (the lost peer ends its collective) well
    inside their 60 s wait instead of hanging."""
    b = case["payload"]["batcher"]
    p = dict(config=TINY, state=case["payload"]["state"], init=b["init"],
             requests=b["requests"][:3])
    lead, follower = W.run_ranks("gpt2_tp_follower_fails", 2, str(tmp_path),
                                 p, mesh={"tensor": 2}, timeout=90)
    assert "injected follower failure" in follower["error"]
    assert lead["errors"] and all(e is not None for e in lead["errors"])
    assert lead["seconds"] < 30
