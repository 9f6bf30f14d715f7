"""ControlNet for the latent-diffusion UNet, PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/controlnet.py
(ControlNetModel, `edge_hint`, `_hint_ladder`, HINT_LADDER): a copy of the
UNet's time embedding, input blocks and middle block whose outputs pass
through zero-initialised 1x1 convs, one per UNet skip connection plus one
for the middle block, so a fresh ControlNet adds exactly nothing. The
hint image [B, 3, H, W] enters a conv ladder (16..256 wide, SiLU between,
stride 2 where `_hint_ladder` puts it) that brings it to the latent grid,
and a zero conv adds it to the first conv's output.

Names are the `control_model.*` layout of the published checkpoints
(without the prefix): the UNet's `time_embed`, `input_blocks`,
`middle_block`, then `input_hint_block.{0,2,..,12}` (the ladder),
`input_hint_block.14` (its zero conv out), `zero_convs.{i}.0` and
`middle_block_out.0`.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.models.latent_diffusion.autoencoder import (
    conv2d,
    init_module_weights,
)
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.unet import (
    build_down_path,
    run_block,
    time_embed,
)

# the published checkpoints' conv ladder: (width, stride)
HINT_LADDER = ((16, 1), (16, 1), (32, 2), (32, 1),
               (96, 2), (96, 1), (256, 2))


def _hint_ladder(vae_factor):
    """HINT_LADDER with its total stride fitted to the VAE's down-sampling
    factor: factor 8 keeps the published ladder; a smaller one keeps the
    last log2(factor) stride-2 positions. Raises where the ladder has too
    few."""
    need = int(math.log2(vae_factor)) if vae_factor > 1 else 0
    stride_positions = [i for i, (_, s) in enumerate(HINT_LADDER) if s == 2]
    if need > len(stride_positions):
        raise ValueError(
            "VAE downsample factor %d needs %d stride-2 hint convs but the "
            "ladder has %d" % (vae_factor, need, len(stride_positions)))
    keep = set(stride_positions[len(stride_positions) - need:]) if need \
        else set()
    return tuple((w, 2 if i in keep else 1)
                 for i, (w, _) in enumerate(HINT_LADDER))


def edge_hint(images, threshold=0.15):
    """Binary Sobel edges [B, H, W, 3] in {0, 1} from images [B, H, W, 3]
    in [-1, 1]: the grey image padded at its edges, the gradient magnitude
    thresholded (the JAX package's stand-in for cv2.Canny)."""
    gray = ((images.float() + 1.0) / 2.0).mean(-1)[:, None]  # [B, 1, H, W]
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=images.device)
    pad = F.pad(gray, (1, 1, 1, 1), mode="replicate")
    gx = F.conv2d(pad, kx[None, None])
    gy = F.conv2d(pad, kx.t()[None, None])
    edges = (torch.sqrt(gx ** 2 + gy ** 2) > threshold).float()
    return edges[:, 0, :, :, None].expand(-1, -1, -1, 3)


class ControlNetModel(nn.Module):
    """(down residuals aligned 1:1 with the UNet's skips, the middle
    residual) from latents x [B, C, h, w], the hint [B, 3, H, W] in
    [0, 1], timesteps [B] and the text context."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        skips = build_down_path(self, config, dtype, device)
        ch = config.model_channels
        ladder = _hint_ladder(2 ** (len(config.vae_channel_mult) - 1))
        layers, c_in = [], 3
        for width, stride in ladder:
            layers += [nn.Conv2d(c_in, width, 3, stride=stride, padding=1,
                                 device=device), nn.SiLU()]
            c_in = width
        layers.append(nn.Conv2d(c_in, ch, 3, padding=1, device=device))
        self.input_hint_block = nn.ModuleList(layers)
        self.zero_convs = nn.ModuleList([
            nn.ModuleList([nn.Conv2d(c, c, 1, device=device)])
            for c in skips])
        self.middle_block_out = nn.ModuleList([
            nn.Conv2d(skips[-1], skips[-1], 1, device=device)])

    def zero_modules(self):
        return ([self.input_hint_block[-1], self.middle_block_out[0]]
                + [z[0] for z in self.zero_convs])

    @torch.no_grad()
    def init_weights(self, generator):
        init_module_weights(self, generator, zero=self.zero_modules())

    @torch.no_grad()
    def copy_from_unet(self, unet):
        """The UNet's time embedding, input blocks and middle block, copied
        (not shared)."""
        for name in ("time_embed", "input_blocks", "middle_block"):
            getattr(self, name).load_state_dict(
                getattr(unet, name).state_dict())

    def forward(self, x, hint, timesteps, context=None):
        dt = self.dtype
        temb = time_embed(self, timesteps)
        g = hint
        for layer in self.input_hint_block:
            g = F.silu(g) if isinstance(layer, nn.SiLU) else conv2d(layer, g,
                                                                    dt)
        h = conv2d(self.input_blocks[0][0], x, dt) + g
        outs = [conv2d(self.zero_convs[0][0], h, dt)]
        for i, block in enumerate(self.input_blocks[1:], start=1):
            h = run_block(block, h, temb, context)
            outs.append(conv2d(self.zero_convs[i][0], h, dt))
        h = run_block(self.middle_block, h, temb, context)
        return outs, conv2d(self.middle_block_out[0], h, dt)
