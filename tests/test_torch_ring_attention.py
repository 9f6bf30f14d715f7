"""The port's ring attention (easynlp_tpu_torch/ops/ring_attention.py,
attention(impl='ring')) held to the JAX package's ring_attention on the
CPU: forward within 2e-5 and gradients within 5e-4 at sequence=4, causal
and not, and ROADMAP C1's fully masked rows. Port ranks are four `gloo`
processes (tests/torch_parallel_workers.py); on the CPU each hop runs the
flash kernels' plain twins."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_workers import run_ranks

N = 4


def _case(causal, seed, masked_row=False, b=2, s=32, h=2, d=8):
    rng = np.random.RandomState(seed)
    case = {n: rng.randn(b, s, h, d).astype(np.float32)
            for n in ("q", "k", "v", "do")}
    mask = np.ones((b, s), np.int32)
    mask[1, 25:] = 0
    if masked_row:
        mask[0] = 0  # every key of batch row 0 masked
    return dict(case, mask=mask, causal=causal)


@functools.lru_cache(maxsize=None)
def _jax_ring_vjp(causal):
    """jit of JAX's ring_attention over sequence=N and its vjp (one
    compilation per causal flag)."""
    from easynlp_tpu.ops.ring_attention import make_ring_attention
    from easynlp_tpu.parallel import build_mesh
    mesh = build_mesh({"sequence": N}, devices=jax.devices()[:N])
    ring = make_ring_attention(mesh, causal=causal)

    def run(q, k, v, mask, do):
        out, vjp = jax.vjp(lambda q, k, v: ring(q, k, v, mask), q, k, v)
        return (out,) + vjp(do)
    return jax.jit(run)


def _jax_ring(case):
    mask = jnp.asarray(case["mask"]).astype(bool)
    got = _jax_ring_vjp(case["causal"])(
        *(jnp.asarray(case[n]) for n in ("q", "k", "v")), mask,
        jnp.asarray(case["do"]))
    return tuple(np.asarray(t) for t in got)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    cases = [_case(False, 0), _case(True, 1), _case(False, 2, True),
             _case(True, 3, True)]
    res = run_ranks("ring", N, str(tmp_path_factory.mktemp("ring")), cases,
                    mesh={"sequence": N})
    whole = []
    for i, case in enumerate(cases):  # the ranks' last entry: launches
        whole.append({k: np.concatenate([r[i][k].numpy() for r in res], 1)
                      for k in ("out", "dq", "dk", "dv")})
    return cases, whole


@pytest.mark.parametrize("i", [0, 1], ids=["full", "causal"])
def test_ring_matches_jax_ring_attention(port_runs, i):
    """Forward within 2e-5 and dq, dk, dv within 5e-4 of jax.vjp through
    JAX's ring_attention over sequence=4 (test_ring_attention.py)."""
    cases, whole = port_runs
    out, dq, dk, dv = _jax_ring(cases[i])
    got = whole[i]
    np.testing.assert_allclose(got["out"], out, atol=2e-5)
    for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[name], want, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("i", [2, 3], ids=["full", "causal"])
def test_c1_fully_masked_rows_take_attentions_mean_of_v(port_runs, i):
    """ROADMAP C1: a query row that sees no key. attention() (the local
    path, and so the port's ring) gives the mean of V over all S keys and
    dO/S to every key's dV; JAX's ring_attention gives zeros there
    (ring_attention.py:59-63). The port's ring equals its local path,
    forward and gradients, and not JAX's ring in those rows."""
    from easynlp_tpu_torch.ops.attention import attention_reference
    cases, whole = port_runs
    case, got = cases[i], whole[i]
    q, k, v = (torch.tensor(case[n], requires_grad=True)
               for n in ("q", "k", "v"))
    want = attention_reference(q, k, v, torch.tensor(case["mask"]),
                               causal=case["causal"])
    want.backward(torch.tensor(case["do"]))
    np.testing.assert_allclose(got["out"], want.detach().numpy(), atol=2e-5)
    np.testing.assert_allclose(got["out"][0],
                               np.broadcast_to(case["v"][0].mean(0),
                                               got["out"][0].shape),
                               atol=2e-5)
    for name, g in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(got[name], g.numpy(), atol=5e-4,
                                   err_msg=name)
    jax_out = _jax_ring(case)[0]
    assert np.abs(jax_out[0]).max() == 0.0
    np.testing.assert_allclose(got["out"][1], jax_out[1], atol=2e-5)
