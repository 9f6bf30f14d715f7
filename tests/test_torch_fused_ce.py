"""The port's chunked cross-entropy (easynlp_tpu_torch/ops/fused_ce.py)
held to the JAX package's on the CPU, on tests/test_fused_ce.py's cases:
chunked_softmax_ce's loss and gradients (a vocabulary that the chunk does
not divide, ignored labels). vocab_parallel_cross_entropy runs on a
tensor group of `gloo` ranks in tests/test_torch_parallel.py, which starts
that group once for its tensor-parallel checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _hidden_emb(n, e, v, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    hidden = jax.random.normal(k[0], (n, e), jnp.float32)
    emb = jax.random.normal(k[1], (v, e), jnp.float32)
    labels = jax.random.randint(k[2], (n,), 0, v).at[3].set(-100)
    return hidden, emb, labels


@pytest.mark.parametrize("v,chunk", [(96, 32), (100, 32), (50, 64)])
def test_chunked_softmax_ce_matches_jax(v, chunk):
    """Loss and the gradients of hidden and embedding within 1e-5 of JAX's
    chunked_softmax_ce (its custom VJP)."""
    from easynlp_tpu.ops.fused_ce import chunked_softmax_ce as jax_ce

    from easynlp_tpu_torch.ops.fused_ce import chunked_softmax_ce
    hidden, emb, labels = _hidden_emb(12, 16, v)
    loss, (gh, ge) = jax.value_and_grad(
        lambda h, w: jax_ce(h, w, labels, chunk), argnums=(0, 1))(hidden,
                                                                  emb)
    h = torch.tensor(np.asarray(hidden), requires_grad=True)
    w = torch.tensor(np.asarray(emb), requires_grad=True)
    got = chunked_softmax_ce(h, w, torch.tensor(np.asarray(labels)),
                             chunk_size=chunk)
    got.backward()
    assert abs(got.item() - float(loss)) < 1e-5
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gh), atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ge), atol=1e-5)
