"""Parameter sharding of the PyTorch port: logical axes to mesh axes.

Counterpart of easynlp_tpu/parallel/sharding.py. The JAX models name a
logical axis on every parameter inside their code, and DEFAULT_RULES maps
those names to mesh axes; GSPMD then inserts the collectives. The port's
modules keep the HF parameter names, so a table per family (TABLES: BERT
and the knowledge models, GLM, GPT-2, BART, T5, BLOOM, the ViT, ARTIST,
TextCNN), declared by the module it covers and composed by submodule,
gives each parameter's logical axes in the torch layout (a parametrized
weight's under its plain name), and the same rules (filtered by
`filter_rules_for_mesh`) decide:

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
  A split head over the vocabulary gathers its columns; a tied head reads
  the vocab-parallel table (tied_logits). Hand-written layers rather than DTensor's parallelize_module: the port's
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

# Tables of logical axes, by parameter name (a regex searched in the name
# relative to the module that declares the table: its `tensor_table`
# attribute) -> the logical axes of the tensor as the port holds it; the
# first match wins. A parameter belongs to the deepest module that
# declares a table, so a model composes its tables by submodule (CLIP: the
# BERT text tower and the ViT; ARTIST: GPT-2 inside, its codebook and
# image head outside). Separate q, k and v projections name their output
# `heads` (a contiguous split keeps whole heads); BLOOM's fused
# query_key_value too, since HF lays it out [H, 3, D]: a contiguous split
# is whole groups of 3D rows. `joined_kv` names a fused [q|k|v] whose
# three sections split each (GLM, GPT-2).
BERT_AXES = (
    (r"word_embeddings\.weight$", ("vocab", "embed")),
    (r"attention\.self\.(query|key|value)\.weight$", ("heads", "embed")),
    (r"attention\.self\.(query|key|value)\.bias$", ("heads",)),
    (r"attention\.output\.dense\.weight$", ("embed", "heads")),
    (r"intermediate\.dense\.weight$", ("mlp", "embed")),
    (r"intermediate\.dense\.bias$", ("mlp",)),
    (r"layer\.\d+\.output\.dense\.weight$", ("embed", "mlp")),
    # the tied MLM head's vocabulary bias (JAX modeling_bert.py:345)
    (r"(^|\.)cls\.(predictions\.)?bias$", ("vocab",)),
)
TABLES = {
    "bert": BERT_AXES,
    # JAX kangaroo/modeling_kangaroo.py:101-107 (the entity attention),
    # :158-174 (intermediate_ent (None, "mlp"), output_ent ("mlp", None))
    "kangaroo": BERT_AXES + (
        (r"attention\.self_ent\.(query|key|value)\.weight$",
         ("heads", "embed")),
        (r"attention\.self_ent\.(query|key|value)\.bias$", ("heads",)),
        (r"attention\.output_ent\.dense\.weight$", ("embed", "heads")),
        (r"intermediate\.dense_ent\.weight$", ("mlp", None)),
        (r"intermediate\.dense_ent\.bias$", ("mlp",)),
        (r"output\.dense_ent\.weight$", (None, "mlp")),
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
    # JAX modeling_gpt2.py:70, :175, :217-220, :245. HF's Conv1D holds
    # [in, out] as flax does, so the axes keep JAX's order
    "gpt2": (
        (r"moe\.(wi|wo|bi|bo)$", ("expert",)),
        (r"wte\.weight$", ("vocab", "embed")),
        (r"attn\.c_attn\.weight$", ("embed", "joined_kv")),
        (r"attn\.c_attn\.bias$", ("joined_kv",)),
        (r"attn\.c_proj\.weight$", ("joined_kv", "embed")),
        (r"mlp\.c_fc\.weight$", ("embed", "mlp")),
        (r"mlp\.c_fc\.bias$", ("mlp",)),
        (r"mlp\.c_proj\.weight$", ("mlp", "embed")),
    ),
    # JAX bart/modeling_bart.py:77-91, :119, :182-187, :221, :287
    "bart": (
        (r"embed_tokens\.weight$", ("vocab", "embed")),
        (r"(self_attn|encoder_attn)\.(q|k|v)_proj\.weight$",
         ("heads", "embed")),
        (r"(self_attn|encoder_attn)\.(q|k|v)_proj\.bias$", ("heads",)),
        (r"(self_attn|encoder_attn)\.out_proj\.weight$", ("embed", "heads")),
        (r"fc1\.weight$", ("mlp", "embed")),
        (r"fc1\.bias$", ("mlp",)),
        (r"fc2\.weight$", ("embed", "mlp")),
        (r"^final_logits_bias$", (None, "vocab")),
    ),
    # JAX t5/modeling_t5.py:79-80 (the relative table), :108-165, :296, :343
    "t5": (
        (r"^shared\.weight$", ("vocab", "embed")),
        (r"^lm_head\.weight$", ("vocab", "embed")),
        (r"(SelfAttention|EncDecAttention)\.(q|k|v)\.weight$",
         ("heads", "embed")),
        (r"(SelfAttention|EncDecAttention)\.o\.weight$", ("embed", "heads")),
        (r"relative_attention_bias\.weight$", (None, "heads")),
        (r"DenseReluDense\.(wi|wi_0|wi_1)\.weight$", ("mlp", "embed")),
        (r"DenseReluDense\.wo\.weight$", ("embed", "mlp")),
    ),
    # JAX bloom/modeling_bloom.py:86-94 (joined_kv over HF's [H, 3, D]
    # rows: whole heads), :128-158
    "bloom": (
        (r"word_embeddings\.weight$", ("vocab", "embed")),
        (r"query_key_value\.weight$", ("heads", "embed")),
        (r"query_key_value\.bias$", ("heads",)),
        (r"self_attention\.dense\.weight$", ("embed", "heads")),
        (r"dense_h_to_4h\.weight$", ("mlp", "embed")),
        (r"dense_h_to_4h\.bias$", ("mlp",)),
        (r"dense_4h_to_h\.weight$", ("embed", "mlp")),
    ),
    # the ViT under HF ChineseCLIP's names (JAX clip/modeling_clip.py:46-60);
    # its embeddings, projections and logit_scale stay whole, as JAX's
    "vit": (
        (r"self_attn\.(q|k|v)_proj\.weight$", ("heads", "embed")),
        (r"self_attn\.(q|k|v)_proj\.bias$", ("heads",)),
        (r"self_attn\.out_proj\.weight$", ("embed", "heads")),
        (r"mlp\.fc1\.weight$", ("mlp", "embed")),
        (r"mlp\.fc1\.bias$", ("mlp",)),
        (r"mlp\.fc2\.weight$", ("embed", "mlp")),
    ),
    # JAX artist/modeling_artist.py:70 (the codebook over codes) and :158
    # (the image head over the vocabulary); GPT-2 inside has its own
    "artist": (
        (r"^quantizer\.codebook$", ("vocab", "kv")),
        (r"^lm_head\.weight$", ("vocab", "embed")),
    ),
    # JAX cnn/modeling_cnn.py:40
    "cnn": ((r"^embeddings\.weight$", ("vocab", "embed")),),
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


def plain_name(name):
    """A parametrized parameter's plain name (LoRA's merge, an int8
    weight): `...weight.parametrizations.weight.original` holds what
    `...weight` names."""
    return re.sub(r"\.parametrizations\.(\w+)\.original\d*$", r".\1", name)


def table_owners(module):
    """[(prefix, table name)] of the submodules that declare a table
    (`tensor_table`), the deepest first."""
    owners = [(n, m.tensor_table) for n, m in module.named_modules()
              if getattr(m, "tensor_table", None)]
    return sorted(owners, key=lambda o: -len(o[0]))


def logical_axes_of(module):
    """{parameter name: logical axes} of every parameter a table names:
    each parameter is looked up, by its plain name relative to the
    deepest module that declares a table, in that table."""
    owners = table_owners(module)
    out = {}
    for name, _ in module.named_parameters():
        plain = plain_name(name)
        for prefix, table in owners:
            if prefix and not plain.startswith(prefix + "."):
                continue
            rel = plain[len(prefix) + 1:] if prefix else plain
            for pattern, axes in TABLES[table]:
                if re.search(pattern, rel):
                    out[name] = axes
                    break
            break
    return out


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


def linear(layer, x, dtype):
    """An f32 nn.Linear (with or without a bias) applied in `dtype`; a
    layer split over the tensor axis adds its collective."""
    if getattr(layer, "tensor_parallel", None) is not None:
        return tensor_parallel_linear(layer, x, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype),
                                      bias)


def tensor_parallel_linear(layer, x, dtype):
    """modeling_bert.dense for a split nn.Linear (layer.tensor_parallel is
    ('column' | 'row' | 'vocab', group)): 'vocab' is a head split over its
    output features whose columns are gathered, padding cut off."""
    kind, group = layer.tensor_parallel
    w = layer.weight.to(dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if kind != "row":
        out = torch.nn.functional.linear(comm.copy_to_group(x, group).to(
            dtype), w, bias)
        if kind == "vocab":
            out = comm.gather_from_group(out, group, out.dim() - 1)
            out = out[..., :layer.vocab_size]
        return out
    out = comm.reduce_from_group(torch.nn.functional.linear(x.to(dtype), w),
                                 group)
    return out if bias is None else out + bias


class VocabParallelEmbedding(nn.Embedding):
    """An embedding holding rows [start, start + rows) of a (padded)
    vocabulary: ids outside look up zeros, and the sum over the tensor
    group completes every row."""

    def setup(self, group, start, vocab_size):
        self.group, self.start, self.vocab_size = group, start, vocab_size

    def forward(self, ids):
        return vocab_parallel_lookup(self.weight, ids, self.start,
                                     self.group)

    def logits(self, hidden, dtype, bias=None):
        """hidden @ (the whole table)^T (+ the bias, split as the table) in
        dtype: each rank's columns, gathered over the group, padding cut
        off."""
        local = torch.matmul(comm.copy_to_group(hidden, self.group),
                             self.weight.to(dtype).t())
        if bias is not None:
            local = local + bias.to(dtype)
        full = comm.gather_from_group(local, self.group, local.dim() - 1)
        return full[..., :self.vocab_size]


def vocab_parallel_lookup(table, ids, start, group):
    """Rows of a table split by rows over the group (this rank's rows
    [start, start + len(table))): each rank looks up its own, zeros
    elsewhere, and the sum over the group completes every row."""
    rows = table.shape[0]
    inside = (ids >= start) & (ids < start + rows)
    local = torch.where(inside, ids - start, torch.zeros_like(ids))
    out = torch.nn.functional.embedding(local, table)
    out = out * inside[..., None].to(out.dtype)
    return comm.reduce_from_group(out, group)


def tied_logits(embedding, hidden, dtype, bias=None):
    """hidden @ embedding.weight^T (+ bias) in dtype, for a tied LM head
    whose table (and bias, split as it) may be vocab-parallel; `embedding`
    the module, or a whole table itself (BertMLMHead called alone)."""
    if isinstance(embedding, VocabParallelEmbedding):
        return embedding.logits(hidden, dtype, bias)
    table = embedding if isinstance(embedding, torch.Tensor) \
        else embedding.weight
    out = torch.matmul(hidden, table.to(dtype).t())
    return out if bias is None else out + bias.to(dtype)


def mesh_axes_of(mesh, rules=DEFAULT_RULES):
    """{logical axis: the mesh axes it is split over} under the rules
    filtered for the mesh (axes of size 1 dropped)."""
    return {logical: physical for logical, physical in
            filter_rules_for_mesh(mesh, rules) if physical}


@torch.no_grad()
def apply_tensor_parallel(module, mesh):
    """Split the module's parameters whose logical axes (logical_axes_of)
    the rules map to the mesh's tensor axis; a layer split on its output
    features is column-parallel, on its input features row-parallel. The
    output features are dim 0 of an nn.Linear's weight [out, in] and dim 1
    of a GPT-2 Conv1D's [in, out] (`weight_in_out`); a fused q|k|v
    (`joined_kv`) splits by head inside its sections only where the joined
    axis is the output. A split `vocab` makes an nn.Embedding
    vocab-parallel and an nn.Linear a head whose columns are gathered;
    other tensors (a codebook, a vocabulary bias) are split and their
    module reads them as such. Then each module with `tensor_parallel_heads`
    (True: `num_heads`, or a tuple of such attributes) keeps its share of
    the heads, `head_start` the first one's global index, and each with a
    `tensor_parallel_split(prefix, specs, mesh)` hook splits what it holds
    besides (LoRA's adapters) and returns their specs. Returns {name:
    TensorSpec}."""
    tp = mesh.size("tensor")
    index = mesh.index("tensor")
    group = mesh.group("tensor")
    split = {a for a, phys in mesh_axes_of(mesh).items()
             if phys == ("tensor",)}
    specs = {}
    modules = dict(module.named_modules())
    for name, axes in logical_axes_of(module).items():
        if not split.intersection(axes):
            continue
        p = module.get_parameter(name)
        dim = next(i for i, a in enumerate(axes) if a in split)
        owner_name, _, attr = name.rpartition(".")
        layer_name, _, layer_attr = plain_name(name).rpartition(".")
        layer = modules[layer_name]
        out_dim = 1 if (layer_attr == "weight"
                        and getattr(layer, "weight_in_out", False)) else 0
        column = dim == out_dim
        sections = 3 if axes[dim] == "joined_kv" and column else 1
        spec = TensorSpec(dim, tp, p.shape[dim], sections)
        if axes[dim] == "vocab" and type(layer) is nn.Embedding:
            emb = VocabParallelEmbedding(
                -(-spec.full // tp), p.shape[1], device=p.device)
            emb.weight = nn.Parameter(spec.shard(p.data, index),
                                      requires_grad=p.requires_grad)
            emb.setup(group, index * emb.weight.shape[0], spec.full)
            parent_name, _, child = layer_name.rpartition(".")
            setattr(modules[parent_name], child, emb)
        else:
            setattr(modules[owner_name], attr, nn.Parameter(
                spec.shard(p.data, index), requires_grad=p.requires_grad))
            if layer_attr == "weight" and not isinstance(layer,
                                                         nn.Embedding):
                kind = "column" if column else "row"
                if axes[dim] == "vocab":
                    kind, layer.vocab_size = "vocab", spec.full
                layer.tensor_parallel = (kind, group)
        specs[name] = spec
    for m in module.modules():
        heads = getattr(m, "tensor_parallel_heads", None)
        if not heads:
            continue
        for attr in ("num_heads",) if heads is True else heads:
            n = getattr(m, attr)
            if n % tp:
                raise ValueError("%d heads do not split over %d tensor "
                                 "ranks" % (n, tp))
            setattr(m, attr, n // tp)
            if attr == "num_heads":
                m.head_start = index * (n // tp)
    for prefix, m in list(module.named_modules()):
        hook = getattr(m, "tensor_parallel_split", None)
        if hook is not None:
            pre = prefix + "." if prefix else ""
            for name, spec in hook(pre, specs, mesh).items():
                specs[pre + name] = spec
    return specs


class DimSplit:
    """A parameter split along `dim` over `group`, this rank `index` of
    `parts`, `full` rows in all: a tensor split's TensorSpec (`spec`: even
    padded parts, or sections), or FSDP2's and the experts' chunks
    (spec None: torch.chunk's, uneven, unpadded). For optimizers whose
    state reduces over a parameter's dims (Adafactor)."""

    def __init__(self, dim, group, index, parts, full, spec=None):
        self.dim, self.group, self.index, self.parts, self.full = (
            dim, group, index, parts, full)
        self.spec = spec

    def _spec(self, dim):
        if self.spec is not None:
            return TensorSpec(dim, self.parts, self.full, self.spec.sections)
        return None

    def gather(self, t, dim):
        """The whole tensor along `dim` from each rank's part t
        (collective)."""
        spec = self._spec(dim)
        if spec is not None:
            return spec.unshard(list(comm.all_gather(t[None], self.group)))
        chunk = -(-self.full // self.parts)
        pad = list(t.shape)
        pad[dim] = chunk - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
        return comm.all_gather(t, self.group, dim).narrow(dim, 0, self.full)

    def local(self, whole, dim, fill=0.0):
        """This rank's part of `whole` along `dim`; padding rows (a padded
        vocabulary's) hold `fill`."""
        spec = self._spec(dim)
        if spec is None:
            chunk = -(-self.full // self.parts)
            start = min(self.index * chunk, self.full)
            return whole.narrow(dim, start, min(chunk, self.full - start))
        part = spec.shard(whole, self.index)
        rows = -(-self.full // self.parts)
        valid = self.full - self.index * rows
        if spec.sections == 1 and valid < rows:
            part = part.narrow(dim, 0, max(valid, 0))
            pad = list(part.shape)
            pad[dim] = rows - part.shape[dim]
            part = torch.cat([part, part.new_full(pad, fill)], dim=dim)
        return part


def param_splits(module, mesh, names):
    """[DimSplit] for each named parameter of the module: its tensor,
    fsdp and expert splits (none off a mesh)."""
    if mesh is None:
        return [[] for _ in names]
    specs = getattr(module, "parallel_specs", {})
    params = dict(module.named_parameters())
    out = []
    for name in names:
        p, splits = params[name], []
        spec = specs.get(name)
        if spec is not None:
            splits.append(DimSplit(spec.dim, mesh.group("tensor"),
                                   mesh.index("tensor"), spec.parts,
                                   spec.full, spec))
        if is_dtensor(p):
            from torch.distributed.tensor import Shard
            for mesh_dim, placement in enumerate(p.placements):
                if isinstance(placement, Shard):
                    axis = p.device_mesh.mesh_dim_names[mesh_dim]
                    splits.append(DimSplit(
                        placement.dim, mesh.group(axis), mesh.index(axis),
                        mesh.size(axis), p.shape[placement.dim]))
        if getattr(p, "expert_parallel", False):
            n = mesh.size("expert")
            splits.append(DimSplit(0, mesh.group("expert"),
                                   mesh.index("expert"), n, n * p.shape[0]))
        out.append(splits)
    return out


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
    axes = mesh_axes_of(mesh)
    module.parallel_mesh = mesh
    if "tensor" in axes.get("heads", ()):
        from easynlp_tpu_torch.modelzoo.quantization import is_quantized
        if is_quantized(module):
            # the JAX package serves no sharded parameters, so this pair
            # has no reference to hold to
            raise NotImplementedError(
                "int8 weights under a tensor axis: quantize_params and "
                "tensor parallelism do not go together")
        if not table_owners(module):
            raise NotImplementedError(
                "tensor parallelism is written for the modules that declare "
                "a table (%s); %s declares none"
                % (", ".join(sorted(TABLES)), type(module).__name__))
        module.parallel_specs = apply_tensor_parallel(module, mesh)
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
    the usual names and shapes; after it, the split parameters again. The
    owners are found by name on the way out too: an export may re-register
    a parametrization (LoRA's plain()), whose new owner holds the name."""

    def __init__(self, module, mesh):
        self.module, self.mesh = module, mesh

    def __enter__(self):
        full = full_state(self.module, self.mesh)
        self.saved = []
        modules = dict(self.module.named_modules())
        for name, value in full.items():
            owner_name, _, attr = name.rpartition(".")
            owner = modules[owner_name]
            self.saved.append((owner_name, attr, owner._parameters[attr]))
            owner._parameters[attr] = nn.Parameter(value,
                                                   requires_grad=False)
        return self.module

    def __exit__(self, *exc):
        modules = dict(self.module.named_modules())
        for owner_name, attr, p in self.saved:
            modules[owner_name]._parameters[attr] = p
        return False
