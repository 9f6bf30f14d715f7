"""Serving-side weight casts for the PyTorch port (the part of
easynlp_tpu/modelzoo/quantization.py that is ported: `cast_params`).
Weight-only int8 and the int8 KV cache are ROADMAP A16."""

import torch

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
    eagerly, where JAX's jit folds that cast away). Returns the module."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    computes_in = {m.dtype for m in module.modules()
                   if isinstance(getattr(m, "dtype", None), torch.dtype)}
    if computes_in == {dtype}:
        skip = tuple(s for s in skip if s != "bias")
    for name, param in module.named_parameters():
        if param.is_floating_point() and not any(
                s in name.lower() for s in skip):
            param.data = param.data.to(dtype)
    return module
