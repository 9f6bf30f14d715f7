"""The port's Switch-MoE (easynlp_tpu_torch/ops/moe.py) and GPT-2's MoE
layers held to the JAX package on the CPU: top-1 and top-2 routing with
capacity drops (outputs, aux loss and gradients within 2e-5), GPT-2 MoE
logits and aux loss, expert parallelism on an expert2 x data2 mesh of
`gloo` ranks (global capacity and bucket positions: the same tokens
dropped as on one device), and MoE training from Python."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torch_parallel_workers import run_ranks


def _jax_moe(e, top_k, capacity_factor, n=(2, 12), d=8, f=16):
    from easynlp_tpu.ops.moe import SwitchMoE
    m = SwitchMoE(d_model=d, d_ff=f, num_experts=e, top_k=top_k,
                  capacity_factor=capacity_factor, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), n + (d,), jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = nn.unbox(m.init({"params": rng, "dropout": rng}, x)["params"])
    # non-zero biases, so a dropped token's zero row is visible
    params = dict(params, bi=params["bi"] + 0.1, bo=params["bo"] - 0.1)
    return m, params, x


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 0.5), (2, 0.6)],
                         ids=["top1-drops", "top2-drops"])
def test_switch_moe_matches_jax(top_k, capacity_factor):
    """Outputs and the aux loss within 2e-5, and the gradients of
    sum(y ** 2) + aux with respect to x and every parameter."""
    from easynlp_tpu_torch.ops.moe import SwitchMoE
    m, params, x = _jax_moe(4, top_k, capacity_factor)

    def loss(p, x):
        y, aux = m.apply({"params": p}, x)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (y, aux)), (g, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    port = SwitchMoE(8, 16, 4, top_k=top_k, capacity_factor=capacity_factor)
    port.load_state_dict({k: torch.tensor(np.asarray(v))
                          for k, v in params.items()})
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    yt, auxt = port(xt)
    ((yt ** 2).sum() + auxt).backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               atol=2e-5)
    assert abs(auxt.item() - float(aux)) < 2e-5
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-5)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g[name]),
                                   atol=2e-5, err_msg=name)
    # some token was dropped: its row is zero, and some was kept
    zero = np.abs(yt.detach().numpy()).reshape(-1, 8).sum(-1) == 0
    assert zero.any() and not zero.all()


def _moe_gpt2_kw(capacity_factor=1.0):
    return dict(vocab_size=64, n_positions=32, n_embd=16, n_layer=2,
                n_head=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                num_experts=4, expert_capacity_factor=capacity_factor)


@functools.lru_cache(maxsize=None)
def _jax_gpt2_init():
    """JAX GPT-2 MoE parameters and logical axes (the capacity factor
    changes no parameter, so one init serves every test)."""
    from easynlp_tpu.appzoo.application import extract_logical_axes
    from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config, GPT2LMHeadModel
    m = GPT2LMHeadModel.from_config(GPT2Config(**_moe_gpt2_kw()),
                                    dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    boxed = m.init({"params": rng, "dropout": rng},
                   input_ids=jnp.ones((1, 4), jnp.int32), deterministic=True)
    return (jax.tree.map(np.asarray, nn.unbox(boxed["params"])),
            extract_logical_axes(boxed["params"]))


def _jax_gpt2(kw):
    from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config, GPT2LMHeadModel
    m = GPT2LMHeadModel.from_config(GPT2Config(**kw), dtype=jnp.float32)
    return m, _jax_gpt2_init()[0]


def _port_gpt2_state(params, kw):
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Config
    from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
        state_dict_from_jax)
    state = state_dict_from_jax(params, GPT2Config(**kw))
    return {"transformer." + k: v.numpy() for k, v in state.items()}


def test_gpt2_moe_expert_parallel_matches_jax(tmp_path):
    """GPT-2 with 4 experts a layer at capacity factor 1.0 (tokens drop) on
    data=2 x expert=2: each rank runs its quarter of the batch and holds 2
    experts, all_to_all carries the buckets; the whole batch's logits
    within 2e-5 and the aux loss within 1e-6 of JAX's expert-sharded run
    (test_moe.py:129-148), whose GSPMD computes capacity, positions and
    the aux means over the whole batch."""
    from easynlp_tpu.parallel.mesh import (build_mesh, get_global_mesh,
                                           set_global_mesh)
    from easynlp_tpu.parallel.sharding import logical_to_sharding
    kw = _moe_gpt2_kw(1.0)
    m, params = _jax_gpt2(kw)
    axes = _jax_gpt2_init()[1]
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (4, 8), 0,
                                        64), np.int32)
    prev = get_global_mesh()
    try:
        mesh = build_mesh({"data": 2, "expert": 2},
                          devices=jax.devices()[:4])
        set_global_mesh(mesh)
        placed = jax.tree.map(
            lambda p, a: jax.device_put(p, logical_to_sharding(a or (),
                                                               mesh)),
            params, axes, is_leaf=lambda x: x is None)
        want = jax.jit(lambda p: m.apply({"params": p},
                                         input_ids=jnp.asarray(ids),
                                         deterministic=True))(placed)
        want = jax.device_get(want)
    finally:
        set_global_mesh(prev)
    res = run_ranks("moe_forward", 4, str(tmp_path), dict(
        config=kw, state=_port_gpt2_state(params, kw), input_ids=ids),
        mesh={"data": 2, "expert": 2})
    for r in res:
        np.testing.assert_allclose(r["logits"].numpy(),
                                   np.asarray(want["logits"]), atol=2e-5)
        assert abs(float(r["aux"]) - float(want["moe_aux_loss"])) < 1e-6


def test_gpt2_moe_builds_and_trains():
    """GPT-2 with num_experts=4 builds (no refusal), matches JAX's logits
    and aux loss on one process, and trains from Python as
    test_moe.py::test_gpt2_moe_trains: aux > 0, router and expert
    gradients flow, 10 Adam steps lower the loss."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.utils import losses
    kw = _moe_gpt2_kw(4.0)
    m, params = _jax_gpt2(kw)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0,
                                        64), np.int32)
    want = m.apply({"params": params}, input_ids=jnp.asarray(ids),
                   deterministic=True)
    model = GPT2LMHeadModel(GPT2Config(**kw))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           _port_gpt2_state(params, kw).items()})
    ids_t = torch.tensor(ids)
    out = model(ids_t)
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(want["logits"]), atol=2e-5)
    assert abs(out["moe_aux_loss"].item()
               - float(want["moe_aux_loss"])) < 1e-6
    labels = torch.cat([ids_t[:, 1:], torch.full((4, 1), -100)], 1)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    def loss_fn():
        out = model(ids_t)
        ce = losses.cross_entropy(out["logits"], labels, ignore_index=-100)
        return ce + out["moe_aux_loss"], out["moe_aux_loss"]

    l0, aux0 = loss_fn()
    assert float(aux0) > 0
    l0.backward()
    moe = model.transformer.h[0].moe
    assert float(moe.router.grad.abs().sum()) > 0
    assert float(moe.wi.grad.abs().sum()) > 0
    for _ in range(10):
        opt.zero_grad()
        loss_fn()[0].backward()
        opt.step()
    assert float(loss_fn()[0]) < float(l0)
