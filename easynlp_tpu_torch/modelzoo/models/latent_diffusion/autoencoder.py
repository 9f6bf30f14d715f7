"""The KL autoencoder (VAE) of latent diffusion for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/autoencoder.py
(VAEResBlock, VAEAttnBlock, VAEEncoder, VAEDecoder, `_gn`) in NCHW, under
the names of CompVis's AutoencoderKL (`encoder.down.{i}.block.{j}.*`,
`encoder.mid.attn_1.*`, `decoder.up.{i}.upsample.conv`, `quant_conv`,
`post_quant_conv`, ...), so a CompVis/PAI-Diffusion `first_stage_model.*`
state dict loads with `load_state_dict`. The numerics are the JAX
modules': parameters f32, convolutions in the compute dtype, GroupNorm
(32 groups, halved until they divide the channels, eps 1e-6) and SiLU in
f32, the moments and the decoder's last conv in f32, log-variance clipped
to [-30, 20].

Where the JAX encoder departs from the CompVis code whose weights it
converts, the port follows CompVis: its down-sampling conv pads the right
and bottom edges only (0, 1, 0, 1) and convolves with padding 0, where
the JAX conv pads one pixel on every side, which moves each encoded latent
by half a pixel (ROADMAP reference fault 29).

The middle attention is one head of width C over the flattened grid
(row-major over (h, w), the order of JAX's NHWC reshape). At 512 pixels its
head dim (512) is past every kernel, so it takes the plain path, as it
takes XLA in the JAX package.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.ops.attention import attention

VAE_GN_EPS = 1e-6
# F.pad order (left, right, top, bottom) of the encoder's down-sampling
# conv: CompVis's Downsample (reference fault 29)
VAE_DOWN_PAD = (0, 1, 0, 1)


def gn_groups(channels, groups=32):
    """32 groups, halved until they divide `channels` (the JAX `_gn`)."""
    while channels % groups:
        groups //= 2
    return groups


def make_group_norm(channels, eps, device=None):
    return nn.GroupNorm(gn_groups(channels), channels, eps=eps, device=device)


def group_norm(layer, x):
    """f32 GroupNorm whatever the input dtype (the JAX `_gn` computes in
    f32)."""
    return F.group_norm(x.float(), layer.num_groups, layer.weight,
                        layer.bias, layer.eps)


def silu_to(x, dtype):
    """SiLU in x's dtype, then cast (the JAX modules' nn.silu(...).astype)."""
    return F.silu(x).to(dtype)


def conv2d(layer, x, dtype):
    """`layer` (an f32 nn.Conv2d) applied in `dtype`, as flax Conv with
    dtype=`dtype` and f32 params does."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    None if layer.bias is None else layer.bias.to(dtype),
                    layer.stride, layer.padding)


@torch.no_grad()
def init_module_weights(module, generator, zero=()):
    """Lecun-normal kernels (std 1/sqrt(fan_in)) with zero biases for the
    convolutions and linears, unit scales for the norms, drawn from
    `generator` in module order; the modules in `zero` start at zero (the
    ControlNet's zero convs)."""
    zero = {id(m) for m in zero}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if id(m) in zero:
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


class VAEResBlock(nn.Module):
    """CompVis ResnetBlock without a timestep: norm1, conv1, norm2, conv2
    and a 1x1 `nin_shortcut` where the width changes."""

    def __init__(self, in_channels, out_channels, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = make_group_norm(in_channels, VAE_GN_EPS, device)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               device=device)
        self.norm2 = make_group_norm(out_channels, VAE_GN_EPS, device)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               device=device)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1,
                                       device=device)
                             if in_channels != out_channels else None)

    def forward(self, x):
        dt = self.dtype
        h = conv2d(self.conv1, silu_to(group_norm(self.norm1, x), dt), dt)
        h = conv2d(self.conv2, silu_to(group_norm(self.norm2, h), dt), dt)
        if self.nin_shortcut is not None:
            x = conv2d(self.nin_shortcut, x, dt)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the grid: GroupNorm, 1x1 q/k/v,
    softmax over the H*W positions, 1x1 proj_out, residual."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm = make_group_norm(channels, VAE_GN_EPS, device)
        self.q = nn.Conv2d(channels, channels, 1, device=device)
        self.k = nn.Conv2d(channels, channels, 1, device=device)
        self.v = nn.Conv2d(channels, channels, 1, device=device)
        self.proj_out = nn.Conv2d(channels, channels, 1, device=device)

    def forward(self, x):
        dt = self.dtype
        b, c, hh, ww = x.shape
        h = group_norm(self.norm, x).to(dt)

        def tokens(layer):  # [B, H*W, 1, C], row-major over (h, w)
            return conv2d(layer, h, dt).flatten(2).transpose(1, 2)[:, :, None]

        out = attention(tokens(self.q), tokens(self.k), tokens(self.v))
        out = out[:, :, 0].transpose(1, 2).reshape(b, c, hh, ww)
        return x + conv2d(self.proj_out, out, dt)


class Downsample(nn.Module):
    """CompVis's VAE Downsample: pad VAE_DOWN_PAD, then a stride-2 3x3 conv
    with no padding of its own."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.pad = VAE_DOWN_PAD
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0,
                              device=device)

    def forward(self, x):
        return conv2d(self.conv, F.pad(x, self.pad), self.dtype)


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then a 3x3 conv."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x):
        return conv2d(self.conv, F.interpolate(x, scale_factor=2,
                                               mode="nearest"), self.dtype)


class _Level(nn.Module):
    """One resolution of the encoder (`block`, `downsample`) or the decoder
    (`block`, `upsample`)."""

    def __init__(self, blocks, sample_name=None, sample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if sample_name is not None:
            setattr(self, sample_name, sample)


class _Mid(nn.Module):
    def __init__(self, channels, dtype, device):
        super().__init__()
        self.block_1 = VAEResBlock(channels, channels, dtype, device)
        self.attn_1 = VAEAttnBlock(channels, dtype, device)
        self.block_2 = VAEResBlock(channels, channels, dtype, device)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class VAEEncoder(nn.Module):
    """pixels [B, 3, H, W] -> the 2 * latent_channels moments (before
    quant_conv), f32."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ch = config.vae_channels
        mults = list(config.vae_channel_mult)
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1, device=device)
        self.down = nn.ModuleList()
        c_in = ch
        for level, mult in enumerate(mults):
            blocks = []
            for _ in range(config.vae_num_res_blocks):
                blocks.append(VAEResBlock(c_in, ch * mult, dtype, device))
                c_in = ch * mult
            last = level == len(mults) - 1
            self.down.append(_Level(blocks, None if last else "downsample",
                                    None if last else
                                    Downsample(c_in, dtype, device)))
        self.mid = _Mid(c_in, dtype, device)
        self.norm_out = make_group_norm(c_in, VAE_GN_EPS, device)
        self.conv_out = nn.Conv2d(c_in, 2 * config.latent_channels, 3,
                                  padding=1, device=device)

    def forward(self, pixels):
        dt = self.dtype
        h = conv2d(self.conv_in, pixels, dt)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        h = silu_to(group_norm(self.norm_out, h), dt)
        return conv2d(self.conv_out, h, torch.float32)


class VAEDecoder(nn.Module):
    """latents [B, latent_channels, h, w] (after post_quant_conv) ->
    pixels [B, 3, H, W], f32."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ch = config.vae_channels
        mults = list(config.vae_channel_mult)
        c_in = ch * mults[-1]
        self.conv_in = nn.Conv2d(config.latent_channels, c_in, 3, padding=1,
                                 device=device)
        self.mid = _Mid(c_in, dtype, device)
        levels = [None] * len(mults)
        for level in reversed(range(len(mults))):
            blocks = []
            for _ in range(config.vae_num_res_blocks + 1):
                blocks.append(VAEResBlock(c_in, ch * mults[level], dtype,
                                          device))
                c_in = ch * mults[level]
            levels[level] = _Level(blocks, "upsample" if level else None,
                                   Upsample(c_in, dtype, device)
                                   if level else None)
        self.up = nn.ModuleList(levels)  # up.0 is the finest level
        self.norm_out = make_group_norm(c_in, VAE_GN_EPS, device)
        self.conv_out = nn.Conv2d(c_in, 3, 3, padding=1, device=device)

    def forward(self, z):
        dt = self.dtype
        h = self.mid(conv2d(self.conv_in, z, dt))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = silu_to(group_norm(self.norm_out, h), dt)
        return conv2d(self.conv_out, h, torch.float32)


class AutoencoderKL(nn.Module):
    """CompVis's first_stage_model: encoder + quant_conv (the moments),
    post_quant_conv + decoder. The 1x1 quant convs run in f32, as JAX's."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        z = config.latent_channels
        self.encoder = VAEEncoder(config, dtype, device)
        self.decoder = VAEDecoder(config, dtype, device)
        self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1, device=device)
        self.post_quant_conv = nn.Conv2d(z, z, 1, device=device)

    def moments(self, pixels):
        """(mean, logvar clipped to [-30, 20]) of the posterior, f32."""
        m = conv2d(self.quant_conv, self.encoder(pixels), torch.float32)
        mean, logvar = m.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(conv2d(self.post_quant_conv, z.float(),
                                   torch.float32))
