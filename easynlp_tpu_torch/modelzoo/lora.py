"""LoRA: low-rank adapters merged functionally into a module's weights.

Counterpart of easynlp_tpu/modelzoo/lora.py (`lora_init`, `lora_apply`,
`lora_merge`, `match_report`, `parse_targets`). The adapters are a dict
parallel to the module's parameters, keyed by parameter name (the HF name
under the app module's prefix, e.g.
`backbone.encoder.layer.0.attention.self.query.weight`): each adapted
weight gets {'a': [in, r], 'b': [r, out]}, the JAX package's layout, so
adapters carry across the two packages as they are. The merged weight is
W + scale * (A @ B)^T for an nn.Linear weight, which is [out, in], and
W + scale * A @ B for GPT-2's Conv1D, which keeps the [in, out] layout of
a JAX kernel. B starts at zero, so the merged module starts as the base.

What is adapted differs from the JAX package (ROADMAP reference fault 19):
there a target matches only 2-D leaves, and the scanned encoders store
every layer's kernel in one 3-D [L, in, out] stack (BERT's fused
projection is named `qkv`), so the default targets adapt no leaf of BERT,
GPT-2 or BART. The port keeps one module per layer, so its targets match
per-layer 2-D weights: with DEFAULT_TARGETS, BERT's `query`, `key` and
`value` of every layer, GPT-2's `c_attn` and `c_proj`, BART's attention
projections.
"""

import torch
from torch import nn

# the JAX package's default targets, unchanged (easynlp_tpu
# modelzoo/lora.py:26-27)
DEFAULT_TARGETS = ("attn", "to_q", "to_k", "to_v", "to_out", "query", "key",
                   "value", "attention_out", "c_attn", "c_proj")


def _match(name, param, targets):
    return param.dim() == 2 and any(t in name for t in targets)


def is_transposed(module, name):
    """True where the weight `name` is [out, in] (an nn.Linear's)."""
    owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else module
    return isinstance(owner, nn.Linear)


def match_report(module, targets=DEFAULT_TARGETS):
    """The names of the weights `targets` adapt."""
    return [n for n, p in module.named_parameters()
            if _match(n, p, targets)]


def lora_init(module, rank=4, targets=DEFAULT_TARGETS, seed=0, dtype=None):
    """{name: {'a': [in, r] ~ N(0, 1) / r, 'b': [r, out] zeros}} for each
    weight of `module` that `targets` match, on its device, trainable."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, p in module.named_parameters():
        if not _match(name, p, targets):
            continue
        d_out, d_in = p.shape if is_transposed(module, name) \
            else p.shape[::-1]
        dt = dtype or p.dtype
        a = torch.randn((d_in, rank), generator=gen) / rank
        out[name] = {
            "a": nn.Parameter(a.to(device=p.device, dtype=dt)),
            "b": nn.Parameter(torch.zeros((rank, d_out), device=p.device,
                                          dtype=dt))}
    return out


def _delta(adapter, scale, transposed):
    d = scale * (adapter["a"].float() @ adapter["b"].float())
    return d.t() if transposed else d


def merge_weight(w, adapter, scale, transposed):
    """W + scale * delta in W's dtype, differentiable in the adapter; W
    takes no gradient (it is detached)."""
    return (w.detach().float() + _delta(adapter, scale, transposed)
            ).to(w.dtype)


def lora_apply(module, base, lora, scale):
    """{name: merged weight} for the adapted names, W from `base` (name ->
    tensor), in W's dtype (merge_weight)."""
    return {name: merge_weight(base[name], ad, scale,
                               is_transposed(module, name))
            for name, ad in lora.items()}


@torch.no_grad()
def lora_merge(module, base, lora, scale):
    """The merged weights with no autograd graph (the write-out form)."""
    return lora_apply(module, base, lora, scale)


def count_lora_params(lora):
    return sum(t.numel() for ad in lora.values() for t in ad.values())


def parse_targets(spec):
    """'query,value' from user_defined_parameters lora_targets; the
    defaults when empty."""
    if not spec:
        return DEFAULT_TARGETS
    return tuple(s.strip() for s in str(spec).split(",") if s.strip())
