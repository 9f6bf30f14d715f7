"""Model base machinery for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/modeling_utils.py. A model here is an
`nn.Module` whose parameters it owns; random init draws from an explicit
`torch.Generator`, and checkpoints are read in the reference/HF
`pytorch_model.bin` layout, which the port's modules keep by name.
"""

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


def load_pytorch_state_dict(model_dir_or_file):
    """Read a reference/HF `pytorch_model.bin` into {name: CPU tensor}."""
    path = model_dir_or_file
    if io.isdir(path):
        path = os.path.join(path, PYTORCH_WEIGHTS_NAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_pytorch_state_dict(state_dict, save_directory):
    """Write {name: tensor} as `pytorch_model.bin` (CPU f32 copies), the
    counterpart of the JAX package's save_params: the port's checkpoints
    keep the reference/HF names, so the port and HF read them back."""
    io.makedirs(save_directory)
    host = {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in state_dict.items()}
    with io.open(os.path.join(save_directory, PYTORCH_WEIGHTS_NAME),
                 "wb") as f:
        torch.save(host, f)


def available_checkpoint(model_dir):
    """Which checkpoint flavour model_dir holds: 'pytorch' | 'flax' | None.
    The port reads only 'pytorch', so it wins when both exist."""
    if io.exists(os.path.join(model_dir, PYTORCH_WEIGHTS_NAME)):
        return "pytorch"
    if io.exists(os.path.join(model_dir, PARAMS_NAME)):
        return "flax"
    return None
