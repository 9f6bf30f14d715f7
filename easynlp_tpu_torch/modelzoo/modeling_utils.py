"""Model base machinery for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/modeling_utils.py. A model here is an
`nn.Module` whose parameters it owns; random init draws from an explicit
`torch.Generator`, and checkpoints are read in the reference/HF
`pytorch_model.bin` layout, which the port's modules keep by name.
"""

import contextlib
import os

import torch

from easynlp_tpu_torch.utils.io_utils import io

PARAMS_NAME = "flax_params.msgpack"
PYTORCH_WEIGHTS_NAME = "pytorch_model.bin"


@torch.no_grad()
def truncated_normal_(tensor, std, generator):
    """BERT-style init in place: N(0, std) truncated at 2 sigma, as the JAX
    package's truncated_normal_init. Draws from `generator` only."""
    torch.nn.init.trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return tensor.mul_(std)


def one_hot_rows(ids, table):
    """table[ids] as a one-hot contraction: ids [..., S] over a table
    [..., N, E] (batch dims broadcast) -> [..., S, E]. The values are the
    lookup's bit for bit (each sum holds one 1.0 * x term and exact
    zeros), and the backward is a matmul, which sums in a fixed order.
    The CUDA backwards of F.embedding over rows that many positions share
    and of torch.gather with repeated indices add in an order that changes
    from run to run, so two runs of one training step would not give the
    same bits (ROADMAP C28, C29)."""
    import torch.nn.functional as F
    return torch.matmul(F.one_hot(ids.long(), table.shape[-2])
                        .to(table.dtype), table)


def load_pytorch_state_dict(model_dir_or_file):
    """Read a reference/HF `pytorch_model.bin` into {name: CPU tensor}."""
    path = model_dir_or_file
    if io.isdir(path):
        path = os.path.join(path, PYTORCH_WEIGHTS_NAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def host_copy(obj):
    """A CPU copy of every tensor in a (nested dict/list/tuple) structure:
    a finished snapshot that later in-place updates on the device do not
    reach. Card tensors are copied into pinned host memory without waiting
    one by one (PyTorch's host allocator keeps the pinned blocks of a
    snapshot once it is freed, for the next), then the copies are waited
    for once."""
    cuda = []

    def copy(x):
        if torch.is_tensor(x):
            x = x.detach()
            if x.device.type != "cuda":
                return x.to("cpu", copy=True).contiguous()
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x, non_blocking=True)
            cuda.append(x.device)
            return out
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    out = copy(obj)
    for device in set(cuda):
        torch.cuda.current_stream(device).synchronize()
    return out


@contextlib.contextmanager
def substituted(module, values):
    """Inside the block the parameters of `module` named in `values` hold
    those tensors (each parameter's .data swapped, cast to its dtype); after
    it, their own again. For writing out other weights under the module's
    names (EMA, merged LoRA) with the app's own export."""
    params = dict(module.named_parameters())
    saved = {}
    with torch.no_grad():
        for name, value in values.items():
            saved[name] = params[name].data
            params[name].data = value.detach().to(params[name].dtype)
    try:
        yield module
    finally:
        for name, data in saved.items():
            params[name].data = data


def available_checkpoint(model_dir):
    """Which checkpoint flavour model_dir holds: 'pytorch' | 'flax' | None.
    The port reads only 'pytorch', so it wins when both exist."""
    if io.exists(os.path.join(model_dir, PYTORCH_WEIGHTS_NAME)):
        return "pytorch"
    if io.exists(os.path.join(model_dir, PARAMS_NAME)):
        return "flax"
    return None
