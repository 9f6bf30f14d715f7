"""ESRGAN's 4x super-resolution net (RRDBNet) for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/esrgan.py:
residual-in-residual dense blocks, then two nearest 2x upsamplings, each
followed by a conv and a leaky ReLU (slope 0.2). Names are the reference
ESRGAN checkpoint's (`conv_first`, `RRDB_trunk.{i}.RDB{1,2,3}.conv{1..5}`,
`trunk_conv`, `upconv1`, `upconv2`, `HRconv`, `conv_last`), the ones the
JAX `convert_rrdbnet` reads; `state_dict_from_jax` unstacks the JAX
module's scanned trunk. Convolutions run in the compute dtype, the last
one in f32, as JAX's.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.models.latent_diffusion.autoencoder import (
    conv2d,
    init_module_weights,
)


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(c_in, c_out, device):
    return nn.Conv2d(c_in, c_out, 3, padding=1, device=device)


class ResidualDenseBlock(nn.Module):
    def __init__(self, nf=64, gc=32, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        for i in range(4):
            setattr(self, "conv%d" % (i + 1), _conv(nf + i * gc, gc, device))
        self.conv5 = _conv(nf + 4 * gc, nf, device)

    def forward(self, x):
        dt = self.dtype
        feats = [x]
        for i in range(1, 5):
            feats.append(_lrelu(conv2d(getattr(self, "conv%d" % i),
                                       torch.cat(feats, 1), dt)))
        return conv2d(self.conv5, torch.cat(feats, 1), dt) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf=64, gc=32, dtype=torch.float32, device=None):
        super().__init__()
        self.RDB1 = ResidualDenseBlock(nf, gc, dtype, device)
        self.RDB2 = ResidualDenseBlock(nf, gc, dtype, device)
        self.RDB3 = ResidualDenseBlock(nf, gc, dtype, device)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """[B, 3, H, W] in [0, 1] -> [B, 3, 4H, 4W]."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=23, gc=32,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv_first = _conv(in_nc, nf, device)
        self.RRDB_trunk = nn.ModuleList([RRDB(nf, gc, dtype, device)
                                         for _ in range(nb)])
        self.trunk_conv = _conv(nf, nf, device)
        self.upconv1 = _conv(nf, nf, device)
        self.upconv2 = _conv(nf, nf, device)
        self.HRconv = _conv(nf, nf, device)
        self.conv_last = _conv(nf, out_nc, device)

    @torch.no_grad()
    def init_weights(self, generator):
        init_module_weights(self, generator)

    def forward(self, x):
        dt = self.dtype
        fea = conv2d(self.conv_first, x, dt)
        trunk = fea
        for block in self.RRDB_trunk:
            trunk = block(trunk)
        fea = fea + conv2d(self.trunk_conv, trunk, dt)
        for conv in (self.upconv1, self.upconv2):
            fea = F.interpolate(fea, scale_factor=2, mode="nearest")
            fea = _lrelu(conv2d(conv, fea, dt))
        out = _lrelu(conv2d(self.HRconv, fea, dt))
        return conv2d(self.conv_last, out, torch.float32)


def state_dict_from_jax(params):
    """The reference names from the JAX RRDBNet tree (numpy leaves; the
    trunk stacked on the scan axis): the inverse of convert_rrdbnet."""
    out = {}

    def put(key, p, i=None):
        kernel, bias = np.asarray(p["kernel"]), np.asarray(p["bias"])
        if i is not None:
            kernel, bias = kernel[i], bias[i]
        out[key + ".weight"] = torch.tensor(
            kernel.transpose(3, 2, 0, 1).astype(np.float32))
        out[key + ".bias"] = torch.tensor(bias.astype(np.float32))

    for name in ("conv_first", "trunk_conv", "upconv1", "upconv2", "HRconv",
                 "conv_last"):
        put(name, params[name])
    trunk = params["trunk"]
    nb = np.asarray(trunk["rdb1"]["conv1"]["kernel"]).shape[0]
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                put("RRDB_trunk.%d.RDB%d.conv%d" % (i, j, k),
                    trunk["rdb%d" % j]["conv%d" % k], i)
    return out


def build_rrdbnet(state_dict, device=None, dtype=torch.float32):
    """An RRDBNet sized from a reference-named state dict, loaded, in eval
    mode."""
    nb = 1 + max(int(k.split(".")[1]) for k in state_dict
                 if k.startswith("RRDB_trunk."))
    nf = state_dict["conv_first.weight"].shape[0]
    gc = state_dict["RRDB_trunk.0.RDB1.conv1.weight"].shape[0]
    net = RRDBNet(nf=nf, nb=nb, gc=gc, dtype=dtype, device=device)
    net.load_state_dict(state_dict, strict=True)
    return net.eval()
