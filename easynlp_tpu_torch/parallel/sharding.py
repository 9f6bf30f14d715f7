"""Parameter sharding of the PyTorch port: logical axes to mesh axes.

Counterpart of easynlp_tpu/parallel/sharding.py. The JAX models name a
logical axis on every parameter inside their code, and DEFAULT_RULES maps
those names to mesh axes; GSPMD then inserts the collectives. The port's
modules keep the HF parameter names, so a table per family (BERT, GLM,
GPT-2) gives each parameter's logical axes in the torch layout, and the
same rules (filtered by `filter_rules_for_mesh`) decide:

- `vocab`, `heads`, `mlp`, `joined_kv` -> `tensor`: hand-written Megatron
  layers. A linear whose output features are split is column-parallel (its
  input's gradient is summed over the group); one whose input features are
  split is row-parallel (its output is summed over the group, then the
  bias added once). A split `vocab` makes the embedding vocab-parallel
  (each rank looks up its rows, the sum over the group completes it); a
  vocabulary that does not divide is padded with zero rows, which no id
  reaches (Megatron's make_vocab_size_divisible_by). A fused [q|k|v]
  projection (GLM's query_key_value, GPT-2's c_attn) splits by head inside
  each of its three sections, so every rank's q, k and v stay whole heads.
  Hand-written layers rather than DTensor's parallelize_module: the port's
  modules compute with the weights directly (modeling_bert.dense and the
  f32/bf16 casts the JAX numerics need), and explicit all_reduce calls
  keep the sums in a fixed order that the CPU tests hold to JAX's.
- `embed` -> `fsdp`: `torch.distributed.fsdp.fully_shard` over the fsdp
  sub-mesh (with the data axis: hybrid sharding) on every layer and on the
  whole module;
- `expert` -> `expert`: ops/moe.SwitchMoE.shard_experts.

`parallelize(module, mesh)` applies all three and records, by parameter
name, how each was split (`module.parallel_specs`), which `full_state`
inverts to write a checkpoint under the usual names and `shard_like`
repeats to load the optimizer state of one.
"""

import re

import torch
from torch import nn

from easynlp_tpu_torch.parallel import comm
from easynlp_tpu_torch.parallel.mesh import BATCH_AXES

# JAX sharding.py:23-37, but for the batch: the port splits it over the
# expert axis too (mesh.BATCH_AXES)
DEFAULT_RULES = (
    ("layers", None),
    ("batch", BATCH_AXES),
    ("length", None),
    ("vocab", "tensor"),
    ("embed", "fsdp"),
    ("embed_out", None),
    ("heads", "tensor"),
    ("kv", None),
    ("joined_kv", "tensor"),
    ("mlp", "tensor"),
    ("classes", None),
    ("stack", None),
    ("expert", "expert"),
)

# parameter name (a regex searched in the HF name) -> logical axes of the
# tensor as the port holds it; the first match wins
FAMILY_AXES = {
    "bert": (
        (r"word_embeddings\.weight$", ("vocab", "embed")),
        (r"attention\.self\.(query|key|value)\.weight$", ("heads", "embed")),
        (r"attention\.self\.(query|key|value)\.bias$", ("heads",)),
        (r"attention\.output\.dense\.weight$", ("embed", "heads")),
        (r"intermediate\.dense\.weight$", ("mlp", "embed")),
        (r"intermediate\.dense\.bias$", ("mlp",)),
        (r"layer\.\d+\.output\.dense\.weight$", ("embed", "mlp")),
    ),
    "glm": (
        (r"word_embeddings\.weight$", ("vocab", "embed")),
        (r"query_key_value\.weight$", ("joined_kv", "embed")),
        (r"query_key_value\.bias$", ("joined_kv",)),
        (r"attention\.dense\.weight$", ("embed", "heads")),
        (r"dense_h_to_4h\.weight$", ("mlp", "embed")),
        (r"dense_h_to_4h\.bias$", ("mlp",)),
        (r"dense_4h_to_h\.weight$", ("embed", "mlp")),
    ),
    "gpt2": (
        (r"moe\.(wi|wo|bi|bo)$", ("expert",)),
    ),
}


def filter_rules_for_mesh(mesh, rules=DEFAULT_RULES):
    """The rules with the mesh axes that are absent or of size 1 dropped,
    so one model runs on one device or any mesh (JAX sharding.py:40)."""
    out = []
    for logical, physical in rules:
        if physical is None:
            out.append((logical, None))
            continue
        phys = physical if isinstance(physical, (list, tuple)) \
            else (physical,)
        kept = tuple(p for p in phys if mesh is not None
                     and mesh.shape.get(p, 1) > 1)
        out.append((logical, kept if kept else None))
    return tuple(out)


def family_of(module):
    names = [n for n, _ in module.named_parameters()]
    if any("attention.self.query" in n for n in names):
        return "bert"
    if any("query_key_value" in n for n in names):
        return "glm"
    if any(".c_attn." in n for n in names):
        return "gpt2"
    return None


def logical_axes(name, family):
    for pattern, axes in FAMILY_AXES.get(family, ()):
        if re.search(pattern, name):
            return axes
    return None


class TensorSpec:
    """How a parameter is split over the tensor group: along `dim`, into
    `parts`; `sections` > 1 splits each of that many equal sections of the
    dim (a fused q|k|v); `full` is the dim's size before padding."""

    def __init__(self, dim, parts, full, sections=1):
        self.dim, self.parts, self.full, self.sections = (
            dim, parts, full, sections)

    def shard(self, t, index):
        """This rank's part of the full tensor t."""
        if self.sections > 1:
            s = t.unflatten(self.dim, (self.sections, -1))
            part = s.chunk(self.parts, dim=self.dim + 1)[index]
            return part.flatten(self.dim, self.dim + 1).contiguous()
        padded = -(-self.full // self.parts) * self.parts
        if padded > self.full:
            pad = list(t.shape)
            pad[self.dim] = padded - self.full
            t = torch.cat([t, t.new_zeros(pad)], dim=self.dim)
        return t.chunk(self.parts, dim=self.dim)[index].contiguous()

    def unshard(self, parts):
        """The full tensor from every rank's part, in rank order."""
        if self.sections > 1:
            s = [p.unflatten(self.dim, (self.sections, -1)) for p in parts]
            return torch.cat(s, dim=self.dim + 1).flatten(self.dim,
                                                          self.dim + 1)
        return torch.cat(parts, dim=self.dim).narrow(self.dim, 0, self.full)


def tensor_parallel_linear(layer, x, dtype):
    """modeling_bert.dense for a split nn.Linear (layer.tensor_parallel is
    ('column' | 'row', group))."""
    kind, group = layer.tensor_parallel
    w = layer.weight.to(dtype)
    if kind == "column":
        return torch.nn.functional.linear(comm.copy_to_group(x, group).to(
            dtype), w, layer.bias.to(dtype))
    out = comm.reduce_from_group(torch.nn.functional.linear(x.to(dtype), w),
                                 group)
    return out + layer.bias.to(dtype)


class VocabParallelEmbedding(nn.Embedding):
    """An embedding holding rows [start, start + rows) of a (padded)
    vocabulary: ids outside look up zeros, and the sum over the tensor
    group completes every row."""

    def setup(self, group, start, vocab_size):
        self.group, self.start, self.vocab_size = group, start, vocab_size

    def forward(self, ids):
        rows = self.weight.shape[0]
        inside = (ids >= self.start) & (ids < self.start + rows)
        local = torch.where(inside, ids - self.start, torch.zeros_like(ids))
        out = torch.nn.functional.embedding(local, self.weight)
        out = out * inside[..., None].to(out.dtype)
        return comm.reduce_from_group(out, self.group)

    def logits(self, hidden, dtype):
        """hidden @ (the whole table)^T in dtype: each rank's columns,
        gathered over the group, padding cut off."""
        local = torch.matmul(hidden, self.weight.to(dtype).t())
        full = comm.gather_from_group(local, self.group, local.dim() - 1)
        return full[..., :self.vocab_size]


def tied_logits(embedding, hidden, dtype):
    """hidden @ embedding.weight^T in dtype, for a tied LM head whose
    table may be vocab-parallel."""
    if isinstance(embedding, VocabParallelEmbedding):
        return embedding.logits(hidden, dtype)
    return torch.matmul(hidden, embedding.weight.to(dtype).t())


def mesh_axes_of(mesh, rules=DEFAULT_RULES):
    """{logical axis: the mesh axes it is split over} under the rules
    filtered for the mesh (axes of size 1 dropped)."""
    return {logical: physical for logical, physical in
            filter_rules_for_mesh(mesh, rules) if physical}


@torch.no_grad()
def apply_tensor_parallel(module, mesh, family):
    """Split the module's parameters whose logical axes the rules map to
    the mesh's tensor axis (the family's table gives the axes); a Linear
    split on its output features (dim 0) is column-parallel, on its input
    features row-parallel. Returns {name: TensorSpec}."""
    tp = mesh.size("tensor")
    index = mesh.index("tensor")
    group = mesh.group("tensor")
    split = {a for a, phys in mesh_axes_of(mesh).items()
             if phys == ("tensor",)}
    specs = {}
    modules = dict(module.named_modules())
    for name, p in list(module.named_parameters()):
        axes = logical_axes(name, family)
        if not axes or not split.intersection(axes):
            continue
        dim = next(i for i, a in enumerate(axes) if a in split)
        sections = 3 if axes[dim] == "joined_kv" else 1
        spec = TensorSpec(dim, tp, p.shape[dim], sections)
        owner_name, _, attr = name.rpartition(".")
        owner = modules[owner_name]
        if axes[dim] == "vocab":
            emb = VocabParallelEmbedding(
                -(-spec.full // tp), p.shape[1], device=p.device)
            emb.weight = nn.Parameter(spec.shard(p.data, index))
            emb.setup(group, index * emb.weight.shape[0], spec.full)
            parent_name, _, child = owner_name.rpartition(".")
            setattr(modules[parent_name], child, emb)
        else:
            setattr(owner, attr, nn.Parameter(spec.shard(p.data, index)))
            if isinstance(owner, nn.Linear) and attr == "weight":
                owner.tensor_parallel = ("column" if dim == 0 else "row",
                                         group)
        specs[name] = spec
    for m in module.modules():
        if hasattr(m, "num_heads") and hasattr(m, "tensor_parallel_heads"):
            if m.num_heads % tp:
                raise ValueError("%d heads do not split over %d tensor "
                                 "ranks" % (m.num_heads, tp))
            m.num_heads //= tp
    return specs


def _fsdp_mesh(mesh):
    if mesh.size("data") > 1:
        return mesh.device_mesh["data", "fsdp"]
    return mesh.device_mesh["fsdp"]


def apply_fsdp(module, mesh, layer_types):
    """fully_shard every layer (instances of layer_types) and then the
    module over the fsdp sub-mesh, hybrid over data when data > 1."""
    from torch.distributed.fsdp import fully_shard
    sub = _fsdp_mesh(mesh)
    for m in list(module.modules()):
        if isinstance(m, layer_types):
            fully_shard(m, mesh=sub)
    fully_shard(module, mesh=sub)


def parallelize(module, mesh):
    """Split the module over the mesh: tensor, expert and fsdp axes, in
    that order, and over a sequence axis turn its attention into the ring.
    The sequence axis alone decides: a config's use_ring_attention asks for
    nothing more, since a ring of one rank is attention() itself (JAX
    attention.py:698-699). Records module.parallel_specs and returns
    the module."""
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import BertLayer
    from easynlp_tpu_torch.modelzoo.models.glm.modeling_glm import GLMLayer
    from easynlp_tpu_torch.ops.moe import SwitchMoE
    module.parallel_specs = {}
    if mesh is None:
        return module
    family = family_of(module)
    axes = mesh_axes_of(mesh)
    if "tensor" in axes.get("heads", ()):
        if family not in ("bert", "glm"):
            raise NotImplementedError(
                "tensor parallelism is written for BERT and GLM; this "
                "module is %s" % family)
        module.parallel_specs = apply_tensor_parallel(module, mesh, family)
    if mesh.size("sequence") > 1:
        # the one trigger of sequence parallelism: the layers attend by the
        # ring and the models split their tokens (parallel/sequence.py)
        for m in module.modules():
            if getattr(m, "impl", None) == "auto":
                m.impl = "ring"
    moe = [m for m in module.modules() if isinstance(m, SwitchMoE)]
    if "expert" in axes.get("expert", ()):
        for m in moe:
            m.shard_experts(mesh.index("expert"), mesh.size("expert"))
    if "fsdp" in axes.get("embed", ()):
        if moe and mesh.size("expert") > 1:
            raise NotImplementedError("fsdp with expert parallelism")
        apply_fsdp(module, mesh, (BertLayer, GLMLayer))
    return module


def is_dtensor(t):
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """The rank's own part of a parameter or gradient (a DTensor's local
    shard, which shares its storage)."""
    return t.to_local().detach() if is_dtensor(t) else t


@torch.no_grad()
def _gather_like(param, value, spec, mesh):
    """The full tensor of `value`, a tensor split as `param` is (its local
    part, or a DTensor)."""
    value = value.detach()
    if is_dtensor(param):
        from torch.distributed.tensor import DTensor
        if not is_dtensor(value):
            value = DTensor.from_local(value, param.device_mesh,
                                       param.placements, shape=param.shape,
                                       stride=param.stride())
        value = value.full_tensor()
    if spec is not None:
        parts = list(comm.all_gather(value[None], mesh.group("tensor")))
        value = spec.unshard(parts)
    if getattr(param, "expert_parallel", False):
        value = comm.all_gather(value, mesh.group("expert"))
    return value


def full_state(module, mesh, tensors=None):
    """{name: full tensor} of the module's parameters (or of `tensors`,
    {name: tensor split as that parameter is}), gathered on every rank:
    collective."""
    specs = getattr(module, "parallel_specs", {})
    params = dict(module.named_parameters())
    values = tensors if tensors is not None else params
    return {name: _gather_like(params[name], v, specs.get(name), mesh)
            for name, v in values.items()}


@torch.no_grad()
def shard_like(param, full, spec, mesh):
    """This rank's part of `full`, split as `param` is (the inverse of
    _gather_like)."""
    if getattr(param, "expert_parallel", False):
        full = full.chunk(mesh.size("expert"))[mesh.index("expert")]
    if spec is not None:
        full = spec.shard(full, mesh.index("tensor"))
    if is_dtensor(param):
        from torch.distributed.tensor import distribute_tensor
        full = distribute_tensor(full.to(param.device), param.device_mesh,
                                 param.placements).to_local()
    return full.contiguous()


class full_parameters:
    """Inside the block each parameter of the module is its full tensor
    (gathered on every rank: collective), so the apps' own exports write
    the usual names and shapes; after it, the split parameters again."""

    def __init__(self, module, mesh):
        self.module, self.mesh = module, mesh

    def __enter__(self):
        full = full_state(self.module, self.mesh)
        self.saved = []
        modules = dict(self.module.named_modules())
        for name, value in full.items():
            owner_name, _, attr = name.rpartition(".")
            owner = modules[owner_name]
            self.saved.append((owner, attr, owner._parameters[attr]))
            owner._parameters[attr] = nn.Parameter(value,
                                                   requires_grad=False)
        return self.module

    def __exit__(self, *exc):
        for owner, attr, p in self.saved:
            owner._parameters[attr] = p
        return False
