"""Sequence parallelism of the port's models (JAX modeling_bert.py:130-132
and modeling_gpt2.py:76 under a sequence axis).

`parallelize` makes a model's attention the ring when the mesh has a
sequence axis (parallel/sharding.py). The model then takes its inputs
whole, and each rank of the sequence group runs its S/n tokens: the
inputs' slice of this rank (`local_tokens`; position ids are cut with the
rest, so they keep their global values, offset by the rank's start), the
layers attending over the ring, and the outputs gathered whole again
(`gather_tokens`), so what reads them (BERT's pooler at token 0, an LM
head) runs as on one device. The gather's gradient is summed over the
group and each rank keeps its chunk: the Trainer averages the gradients
over the sequence axis.
"""

from easynlp_tpu_torch.parallel import comm
from easynlp_tpu_torch.parallel.mesh import axis_group


def sequence_group(attention_module):
    """The mesh's sequence group when the module attends by the ring and
    the group has more than one rank, else None."""
    if getattr(attention_module, "impl", None) != "ring":
        return None
    return axis_group("sequence")


def local_tokens(group, *tensors):
    """This rank's S/n tokens (dim 1) of each [B, S, ...] tensor; None
    stays None."""
    s = next(t.shape[1] for t in tensors if t is not None)
    n, r = comm.size(group), comm.rank(group)
    if s % n:
        raise ValueError("sequence length %d does not split over %d "
                         "sequence ranks" % (s, n))
    c = s // n
    return tuple(None if t is None else t[:, r * c:(r + 1) * c]
                 for t in tensors)


def gather_tokens(t, group, dim=1):
    """The whole sequence of every rank's tokens along dim (gradient:
    reduce-scatter)."""
    return comm.gather_averaged(t, group, dim)
