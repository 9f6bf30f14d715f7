"""The one-hot row lookups that repaired ROADMAP C28 and C29
(modeling_utils.one_hot_rows) against the lookups they replace, on the CPU
in f32.

On a card, the CUDA backwards of F.embedding over rows that many
positions share (T5's 32-row relative-position table, Kangaroo's sample
positions) and of torch.gather with repeated indices (Kangaroo's entity
rows) add in an order that changes from run to run; the one-hot
contraction's backward is a matmul, which does not. Forward values are
the lookup's bit for bit (each sum is one 1.0 * x term and exact zeros);
gradients are the same sums of the same terms in another order, so each
element of the two agrees within twice the f32 summation bound,
2 (n - 1) 2^-24 sum |x_i|, with n the count of terms (`_bound`).
"""

import torch
import torch.nn.functional as F

from easynlp_tpu_torch.modelzoo.modeling_utils import one_hot_rows


def _grads(fn, leaf, grad_out):
    leaf = leaf.detach().clone().requires_grad_(True)
    out = fn(leaf)
    out.backward(grad_out)
    return out.detach(), leaf.grad


def _bound(fn, leaf, grad_out, n):
    """2 (n - 1) 2^-24 sum |x_i| per element of leaf's gradient: the sum
    of |x_i| is the lookup's backward of |grad_out|."""
    return 2 * (n - 1) * 2.0 ** -24 * _grads(fn, leaf, grad_out.abs())[1]


def assert_within(got, want, bound, msg=None):
    excess = (got - want).abs() - bound
    assert excess.max() <= 0, (msg, float(excess.max()))


def test_t5_relative_bias_matches_the_embedding_lookup():
    """T5RelativeBias.bias over 96 x 96 (bidirectional), a decode step at
    offset 7 and a causal 40 x 40: the bias bit for bit, the table's
    gradient within rounding."""
    from easynlp_tpu_torch.modelzoo.models.t5 import T5Config
    from easynlp_tpu_torch.modelzoo.models.t5.modeling_t5 import (
        T5RelativeBias)
    cfg = T5Config(vocab_size=32, d_model=16, d_kv=4, num_heads=4,
                   num_layers=1, relative_attention_num_buckets=32,
                   relative_attention_max_distance=128)
    g = torch.Generator().manual_seed(0)
    for bidirectional, (q_start, sq, skv) in ((True, (0, 96, 96)),
                                              (False, (7, 1, 8)),
                                              (False, (0, 40, 40))):
        table = T5RelativeBias(cfg, bidirectional)
        with torch.no_grad():
            table.weight.copy_(torch.randn(table.weight.shape, generator=g))
        lut = table._lut(max(q_start + sq, skv), table.weight.device)
        n = (lut.shape[0] + 1) // 2
        rel = (torch.arange(skv)[None, :]
               - torch.arange(q_start, q_start + sq)[:, None])
        buckets = lut[rel + (n - 1)]
        grad_out = torch.randn((1, 4, sq, skv), generator=g)
        want, want_grad = _grads(
            lambda w: F.embedding(buckets, w).permute(2, 0, 1)[None],
            table.weight, grad_out)
        got = table.bias(q_start, sq, skv)
        got.backward(grad_out)
        assert torch.equal(got.detach(), want)
        assert_within(table.weight.grad, want_grad, _bound(
            lambda w: F.embedding(buckets, w).permute(2, 0, 1)[None],
            table.weight, grad_out, sq * skv))


def test_entity_gathers_match_torch_gather():
    """Kangaroo's entity rows: [B, S] indices (most 0, the no-entity row)
    into a [B, N + 1, E] table, and the negatives' [B, N + 1, K - 1, E]
    through a flattened last axis; values bit for bit, the tables'
    gradients within rounding."""
    g = torch.Generator().manual_seed(1)
    b, s, n, k, e = 4, 64, 3, 3, 12
    index = torch.randint(0, n + 1, (b, s), generator=g)
    index[:, s // 2:] = 0
    table = torch.randn((b, n + 1, e), generator=g)
    grad_out = torch.randn((b, s, e), generator=g)
    want, want_grad = _grads(lambda t: torch.gather(
        t, 1, index[..., None].expand(b, s, e)), table, grad_out)
    got, got_grad = _grads(lambda t: one_hot_rows(index, t), table, grad_out)
    assert torch.equal(got, want)
    assert_within(got_grad, want_grad, _bound(
        lambda t: torch.gather(t, 1, index[..., None].expand(b, s, e)),
        table, grad_out, s))
    neg = torch.randn((b, n + 1, k - 1, e), generator=g)
    grad_out = torch.randn((b, s, k - 1, e), generator=g)
    want, want_grad = _grads(lambda t: torch.gather(
        t, 1, index[..., None, None].expand(b, s, k - 1, e)), neg, grad_out)
    got, got_grad = _grads(lambda t: one_hot_rows(index, t.flatten(2)).view(
        b, s, k - 1, e), neg, grad_out)
    assert torch.equal(got, want)
    assert_within(got_grad, want_grad, _bound(
        lambda t: torch.gather(t, 1, index[..., None, None].expand(
            b, s, k - 1, e)), neg, grad_out, s))


def test_bert_embeddings_one_hot_positions_match_the_lookup():
    """BertEmbeddings(one_hot_positions=True), as Kangaroo's sample
    encoding calls it (position ids with long runs of 0): the embeddings
    and every other gradient bit for bit, the position table's gradient
    within the bound over the gradient that reaches its rows."""
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        BertEmbeddings)
    cfg = BertConfig(vocab_size=50, hidden_size=16,
                     max_position_embeddings=64, hidden_dropout_prob=0.0)
    emb = BertEmbeddings(cfg)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 50, (24, 32), generator=g)
    pos = torch.arange(32)[None].repeat(24, 1)
    pos[:, 10:] = 0  # padded sample positions
    types = torch.zeros_like(ids)
    grad_out = torch.randn((24, 32, 16), generator=g)
    rows = {}

    def keep(module, inputs, out):  # the rows the lookup path reads
        out.retain_grad()
        rows["out"] = out
    hook = emb.position_embeddings.register_forward_hook(keep)
    outs = {}
    for one_hot in (False, True):
        emb.zero_grad()
        out = emb(ids, types, pos, one_hot_positions=one_hot)
        out.backward(grad_out)
        outs[one_hot] = (out.detach(), {n: p.grad.clone() for n, p
                                        in emb.named_parameters()})
    hook.remove()
    assert torch.equal(outs[True][0], outs[False][0])
    terms = rows["out"].grad.abs().reshape(-1, 16)
    bound = 2 * (ids.numel() - 1) * 2.0 ** -24 * torch.zeros(
        64, 16).index_add_(0, pos.reshape(-1), terms)
    for name, grad in outs[False][1].items():
        if name == "position_embeddings.weight":
            assert_within(outs[True][1][name], grad, bound, name)
        else:
            assert torch.equal(outs[True][1][name], grad), name
