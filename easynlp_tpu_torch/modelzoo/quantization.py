"""Weight-only int8 quantization and serving-side weight casts for the
PyTorch port.

Counterpart of easynlp_tpu/modelzoo/quantization.py over `nn.Module`s:
`quantize_params`, `dequantize_params`, `dequantize_for`, `is_quantized`,
`quantization_report` and `cast_params`.

A quantized weight stays on the device as int8 with f32 per-output-channel
scales (symmetric, q in [-127, 127], scale = max|w| over the input axis /
127), held by a `torch.nn.utils.parametrize` parametrization (`Int8Weight`)
whose originals are the int8 tensor and the scale. Every read of the
weight, so every forward, dequantizes it as the JAX package does once per
dispatch: q.to(dtype) * scale.to(dtype) in the model's compute dtype
(in bf16 the scale is rounded to bf16 first, as JAX's
`q.astype(dtype) * scale.astype(dtype)` does), the product then given the
weight's own dtype so the consumer reads the dtype it always read.

Which tensors: those the JAX package quantizes. It decides on the flax
leaf path and the leaf's size, and the port keeps other names and one
module per layer, so `quantize_params` maps each weight onto its JAX leaf:

- an `nn.Embedding`'s table is the JAX `.../embedding` leaf, which the
  "embed" skip leaves alone (GPT-2's tied `transformer.wte.weight` holds
  no "embed" in the port's name);
- `min_size` counts the JAX leaf: a weight of a per-layer `nn.ModuleList`
  (the JAX package scans those stacks into one [L, in, out] leaf) counts
  L times its size, and BERT's query/key/value count as the one fused
  `qkv` leaf they are there (3 times);
- the scales reduce over the input axis: dim -1 of an `nn.Linear` weight
  ([out, in]), dim 0 of a GPT-2 `Conv1D` weight ([in, out], the JAX
  kernel's layout).
"""

import torch
from torch import nn
from torch.nn.utils import parametrize

# substrings of (lower-cased) parameter names never quantized: tiny and/or
# precision-critical (the JAX DEFAULT_SKIP)
DEFAULT_SKIP = ("layernorm", "layer_norm", "ln_", "_ln", "norm", "bias",
                "embed", "temb", "scale", "shift")
# port weights the JAX package holds as one leaf: (name parts, leaf count)
_FUSED = ((("attention.self.query.", "attention.self.key.",
            "attention.self.value."), 3),)


def quantize_tensor(w, dim):
    """(int8 q, f32 scale): symmetric per-channel int8 of `w` with the
    absolute maximum taken over `dim` (kept as a size-1 axis), as the JAX
    _quantize_leaf computes it in f32."""
    w32 = w.detach().float()
    absmax = w32.abs().amax(dim=dim, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which rounds differently from numpy's division
    scale = absmax / torch.full_like(absmax, 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(w32 / safe).clamp(-127, 127).to(torch.int8)
    return q, scale


class Int8Weight(nn.Module):
    """The parametrization of a quantized weight: originals (q, scale);
    the weight read is (q.to(dtype) * scale.to(dtype)).to(out_dtype),
    dtype the model's compute dtype, out_dtype the weight's dtype."""

    def __init__(self, dim, dtype, out_dtype):
        super().__init__()
        self.dim, self.dtype, self.out_dtype = dim, dtype, out_dtype

    def forward(self, q, scale):
        return (q.to(self.dtype) * scale.to(self.dtype)).to(self.out_dtype)

    def right_inverse(self, w):
        return quantize_tensor(w, self.dim)


def compute_dtype(module):
    """The dtype a module computes in (its `dtype`, else the one dtype
    its submodules declare), else f32: what JAX's dequantize_for reads
    from module.dtype."""
    dtype = getattr(module, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return dtype
    found = {m.dtype for m in module.modules()
             if isinstance(getattr(m, "dtype", None), torch.dtype)}
    return found.pop() if len(found) == 1 else torch.float32


def _stack_factor(module, name):
    """How many per-layer copies of `name` the JAX package stacks into one
    leaf: the product of the lengths of the layer lists on its path (a
    ModuleList of one class whose members all hold the parameter)."""
    parts = name.split(".")
    factor, owner = 1, module
    for i, part in enumerate(parts[:-1]):
        child = owner._modules.get(part) if part in owner._modules else None
        if child is None:
            break
        if isinstance(child, nn.ModuleList) and len(child) > 1 \
                and len({type(m) for m in child}) == 1:
            rest = ".".join(parts[i + 2:])
            try:
                shapes = {tuple(m.get_parameter(rest).shape) for m in child}
            except AttributeError:
                shapes = {None, ()}
            if len(shapes) == 1:
                factor *= len(child)
        owner = child
    return factor


def _fused_factor(name):
    for group, count in _FUSED:
        if any(part in name for part in group):
            return count
    return 1


def quantize_targets(module, skip=DEFAULT_SKIP, min_size=4096):
    """{name: reduction dim} of the weights quantize_params quantizes:
    floating, ndim >= 2, not an embedding table, no `skip` substring in
    the lower-cased name, and a JAX leaf of >= min_size elements."""
    out = {}
    for name, param in module.named_parameters():
        if param.dim() < 2 or not param.is_floating_point() \
                or any(s in name.lower() for s in skip):
            continue
        owner = module.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else module
        if isinstance(owner, nn.Embedding):
            continue
        size = param.numel() * _stack_factor(module, name) \
            * _fused_factor(name)
        if size < min_size:
            continue
        out[name] = -1 if isinstance(owner, nn.Linear) else param.dim() - 2
    return out


@torch.no_grad()
def quantize_params(module, skip=DEFAULT_SKIP, min_size=4096):
    """Quantize `module`'s weights in place (quantize_targets picks them):
    each becomes int8 + f32 scales under an Int8Weight parametrization,
    frozen. Returns the module."""
    dtype = compute_dtype(module)
    for name, dim in quantize_targets(module, skip, min_size).items():
        owner_name, attr = name.rsplit(".", 1) if "." in name \
            else ("", name)
        owner = module.get_submodule(owner_name)
        weight = getattr(owner, attr)
        weight.requires_grad_(False)
        parametrize.register_parametrization(
            owner, attr, Int8Weight(dim, dtype, weight.dtype), unsafe=True)
    return module


def _int8_weights(module):
    """[(owner, attr name, full name, Int8Weight)] of module's quantized
    weights."""
    out = []
    for owner_name, owner in module.named_modules():
        if not parametrize.is_parametrized(owner):
            continue
        for attr, plist in owner.parametrizations.items():
            if isinstance(plist[0], Int8Weight):
                full = owner_name + "." + attr if owner_name else attr
                out.append((owner, attr, full, plist[0]))
    return out


def is_quantized(module):
    return bool(_int8_weights(module))


@torch.no_grad()
def dequantize_for(module):
    """{name: the weight a forward reads} for each quantized weight:
    q.to(dtype) * scale.to(dtype) at the module's compute dtype.

    The JAX docstring calls bf16 dequantization "bit-identical at the MXU"
    to f32 dequantization. The port claims no such thing: in bf16 the
    scale is rounded to bf16 before the product, so the weight can differ
    from the f32 product rounded once. tests/test_torch_quantization.py
    measures what holds: these bits equal JAX's dequantize_for's in f32
    and in bf16."""
    return {full: p(owner.parametrizations[attr].original0,
                    owner.parametrizations[attr].original1).to(p.dtype)
            for owner, attr, full, p in _int8_weights(module)}


@torch.no_grad()
def dequantize_params(module, dtype=torch.float32):
    """Inverse of quantize_params, in place: each quantized weight becomes
    a plain parameter holding q.to(dtype) * scale.to(dtype) (JAX's
    dequantize_params). The identity on an unquantized module."""
    for owner, attr, _, p in _int8_weights(module):
        p.dtype = p.out_dtype = dtype
        value = getattr(owner, attr).detach().clone()
        parametrize.remove_parametrizations(owner, attr,
                                            leave_parametrized=True)
        # a multi-tensor parametrization leaves the value as a buffer
        owner._buffers.pop(attr, None)
        owner.__dict__.pop(attr, None)
        owner.register_parameter(attr, nn.Parameter(value,
                                                    requires_grad=False))
    return module


def quantization_report(module):
    """(quantized bytes, original-equivalent bytes, quantized weights): the
    bytes as JAX's report counts them (an int8 weight as 1 byte an element
    plus 4 a scale, against 4 an element; every other parameter at its own
    size in both). The count is of the port's weights, one a layer, where
    JAX counts its stacked [L, ...] leaves."""
    qbytes = obytes = n = 0
    originals = set()
    for owner, attr, full, _ in _int8_weights(module):
        q = owner.parametrizations[attr].original0
        scale = owner.parametrizations[attr].original1
        qbytes += q.numel() + 4 * scale.numel()
        obytes += 4 * q.numel()
        n += 1
        originals.add(id(q))
        originals.add(id(scale))
    for param in module.parameters():
        if id(param) not in originals:
            size = param.numel() * param.element_size()
            qbytes += size
            obytes += size
    return qbytes, obytes, n


# parameter names (lower-cased) that keep their dtype: LayerNorm scales and
# shifts and biases are tiny and precision-sensitive (the JAX CAST_SKIP;
# cast_params drops "bias" where the module computes in the cast dtype)
CAST_SKIP = ("layernorm", "layer_norm", "ln_", "_ln", "norm", "bias",
             "scale", "shift")


@torch.no_grad()
def cast_params(module, dtype=torch.bfloat16, skip=CAST_SKIP):
    """Cast `module`'s floating parameters to `dtype` in place, except those
    whose name holds a `skip` substring. `module` is a backbone (GPT-2's
    GPT2LMHeadModel, an app's `backbone`): its projections cast their
    weights to the compute dtype on use and its LayerNorms run in f32, so
    any weight dtype serves. The apps' heads run in f32 on f32 inputs and
    are left out (the JAX package casts them too, and flax promotes them
    back to f32 on use). Checkpoints store f32 weights and
    the projections compute in bf16 anyway, so this halves the weight bytes
    each step reads (GPT-2's tied head reads the [V, E] table every decode
    step) and drops the per-call weight casts; the products are the same
    bf16 products. Where `dtype` is the compute dtype of every submodule
    that declares one (its `dtype` attribute), the biases
    are cast too: every projection casts its bias to that dtype on use, so
    the sums are the same and each call saves a cast kernel (the port runs
    eagerly, where JAX's jit folds that cast away). An int8 weight
    (quantize_params) keeps its int8 and f32 scales, as JAX's cast passes
    its int8 leaves through; its dequantized read is then given `dtype`.
    Returns the module."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    computes_in = {m.dtype for m in module.modules()
                   if isinstance(getattr(m, "dtype", None), torch.dtype)}
    if computes_in == {dtype}:
        skip = tuple(s for s in skip if s != "bias")
    for _, _, name, p in _int8_weights(module):
        if not any(s in name.lower() for s in skip):
            p.out_dtype = dtype
    for name, param in module.named_parameters():
        if ".parametrizations." in "." + name:
            continue
        if param.is_floating_point() and not any(
                s in name.lower() for s in skip):
            param.data = param.data.to(dtype)
    return module
