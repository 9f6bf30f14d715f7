"""Poincaré concept embeddings for Kangaroo (the PyTorch port's own copy of
easynlp_tpu/utils/poincare.py, in numpy: from one seed both give the same
embedding bit for bit).

Capability parity: reference examples/kangaroo_pretraining/poincare_embedding
(Nickel & Kiela hyperbolic embeddings; the reference's negative samplers are
Cython, hype/graph_dataset.pyx, and its optimiser is torch RSGD). Here the
whole pipeline is vectorised numpy: batched negative sampling over the edge
list and Riemannian SGD on the Poincaré ball. Output feeds
KangarooPretrainDataset's concept_emb_file ({entity_id: vector} npy).
"""

import numpy as np

EPS = 1e-7
BOUNDARY = 1.0 - 1e-5


def poincare_distance(u, v):
    """d(u,v) = arcosh(1 + 2|u-v|²/((1-|u|²)(1-|v|²))). u,v [..., D]."""
    uu = np.sum(u * u, axis=-1)
    vv = np.sum(v * v, axis=-1)
    duv = np.sum((u - v) ** 2, axis=-1)
    alpha = np.maximum(1.0 - uu, EPS)
    beta = np.maximum(1.0 - vv, EPS)
    gamma = np.maximum(1.0 + 2.0 * duv / (alpha * beta), 1.0 + EPS)
    return np.arccosh(gamma)


def _project(x):
    """Clip back inside the unit ball (RSGD retraction)."""
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    scale = np.where(norm >= BOUNDARY, BOUNDARY / (norm + EPS), 1.0)
    return x * scale


class PoincareEmbedding:
    """Train hyperbolic embeddings of a concept DAG's transitive-closure
    edges with the standard softmax-over-negatives objective."""

    def __init__(self, num_nodes, dim=100, seed=0):
        rng = np.random.RandomState(seed)
        self.theta = rng.uniform(-1e-3, 1e-3, (num_nodes, dim))
        self.num_nodes = num_nodes

    def _neg_sample(self, rng, heads, adjacency, n_neg):
        """Negatives uniform over non-neighbours (the .pyx sampler's
        behaviour, vectorised with rejection resampling)."""
        neg = rng.randint(0, self.num_nodes, (len(heads), n_neg))
        for _ in range(3):  # a few rejection rounds are enough in practice
            bad = np.zeros_like(neg, dtype=bool)
            for i, h in enumerate(heads):
                bad[i] = np.isin(neg[i], adjacency.get(h, ()))
            if not bad.any():
                break
            neg = np.where(bad, rng.randint(0, self.num_nodes, neg.shape),
                           neg)
        return neg

    def train(self, edges, epochs=50, lr=0.3, n_neg=10, batch_size=512,
              burn_in=10, seed=0):
        """edges: [(child, parent)] pairs. Returns the embedding matrix."""
        rng = np.random.RandomState(seed)
        edges = np.asarray(edges, np.int64)
        adjacency = {}
        for h, t in edges:
            adjacency.setdefault(int(h), set()).add(int(t))
            adjacency.setdefault(int(t), set()).add(int(h))

        for epoch in range(epochs):
            cur_lr = lr / 10.0 if epoch < burn_in else lr
            order = rng.permutation(len(edges))
            for start in range(0, len(edges), batch_size):
                batch = edges[order[start:start + batch_size]]
                heads, tails = batch[:, 0], batch[:, 1]
                neg = self._neg_sample(rng, heads, adjacency, n_neg)
                # candidates: positive first, then negatives [B, 1+n_neg]
                cand = np.concatenate([tails[:, None], neg], axis=1)
                u = self.theta[heads]                       # [B, D]
                v = self.theta[cand]                        # [B, K, D]
                d = poincare_distance(u[:, None, :], v)     # [B, K]
                # softmax CE with target index 0, gradients wrt distance
                expd = np.exp(-d - (-d).max(1, keepdims=True) * 0)
                p = expd / np.maximum(expd.sum(1, keepdims=True), EPS)
                gd = p.copy()
                gd[:, 0] -= 1.0                             # dL/dd = p - y
                gd = -gd  # L = d_pos + log Σ exp(-d): dL/dd_k = y_k - p_k

                # Euclidean gradient of the distance wrt u and v
                uu = np.sum(u * u, -1)[:, None]
                vv = np.sum(v * v, -1)
                duv = np.sum((u[:, None, :] - v) ** 2, -1)
                alpha = np.maximum(1.0 - uu, EPS)
                beta = np.maximum(1.0 - vv, EPS)
                gamma = 1.0 + 2.0 * duv / (alpha * beta)
                denom = np.maximum(np.sqrt(gamma ** 2 - 1.0), EPS)[..., None]
                du = (4.0 / (beta * denom[..., 0] * alpha ** 2))[..., None] \
                    * ((vv - 2 * np.sum(u[:, None] * v, -1)
                        + uu) / alpha)[..., None] * u[:, None] \
                    - (4.0 / (alpha * beta * denom[..., 0]))[..., None] * v
                dv_ = (4.0 / (alpha * denom[..., 0] * beta ** 2))[..., None] \
                    * ((uu - 2 * np.sum(u[:, None] * v, -1)
                        + vv) / beta)[..., None] * v \
                    - (4.0 / (alpha * beta * denom[..., 0]))[..., None] \
                    * u[:, None]

                # Riemannian scaling: ((1-|x|²)²/4) * euclidean grad
                ru = ((alpha ** 2) / 4.0)[..., None] * (gd[..., None] * du)
                rv = ((beta ** 2) / 4.0)[..., None] * (gd[..., None] * dv_)

                np.add.at(self.theta, heads, -cur_lr * ru.sum(1))
                np.add.at(self.theta, cand.ravel(),
                          -cur_lr * rv.reshape(-1, rv.shape[-1]))
                self.theta = _project(self.theta)
        return self.theta


def train_concept_embeddings(edges, num_nodes, dim=100, out_file=None,
                             **kwargs):
    """Convenience: edges → {node_id: vector} dict (optionally saved as the
    npy Kangaroo's dataset loads)."""
    emb = PoincareEmbedding(num_nodes, dim=dim).train(edges, **kwargs)
    table = {int(i): emb[i].astype(np.float32).tolist()
             for i in range(num_nodes)}
    if out_file:
        np.save(out_file, table, allow_pickle=True)
    return table
