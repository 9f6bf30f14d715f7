"""The latent-diffusion UNet for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/unet.py
(`timestep_embedding`, ResBlock, SpatialTransformer, UNetModel) in NCHW,
under the names of CompVis's openaimodel.UNetModel (`time_embed.{0,2}`,
`input_blocks.{i}.{0,1}`, `input_blocks.{i}.0.op`, `middle_block.{0,1,2}`,
`output_blocks.{i}.{0,1,2}`, `out.{0,2}`; ResBlocks' `in_layers.{0,2}`,
`emb_layers.1`, `out_layers.{0,3}`, `skip_connection`; the transformers'
`norm`, `proj_in`, `transformer_blocks.0.{attn1,attn2}.{to_q,to_k,to_v,
to_out.0}`, `ff.net.{0.proj,2}`, `norm{1,2,3}`, `proj_out`), so a
CompVis/PAI-Diffusion `model.diffusion_model.*` state dict loads with
`load_state_dict`. The numerics are the JAX modules': parameters f32,
convolutions and projections in the compute dtype, norms and the timestep
MLP in f32, the output conv in f32.

Self- and cross-attention go through ops/attention.py (the kernels on a
card). The cross-attention passes no mask, as the JAX module does, so a
prompt's padding tokens are attended. The grid flattens row-major over
(h, w), as JAX's NHWC reshape does.

Where the JAX module departs from the CompVis code whose weights
`convert_sd_unet` reads, the port follows CompVis (ROADMAP reference
faults 30-32): the gated MLP's GELU is exact (JAX: the tanh
approximation), the transformer's GroupNorm eps is 1e-6 (JAX: 1e-5, the
ResBlocks' value) and its LayerNorm eps is 1e-5 (JAX: flax's 1e-6). The
constants below hold each value; a module reads them when it is built.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.models.latent_diffusion.autoencoder import (
    conv2d,
    group_norm,
    make_group_norm,
    silu_to,
)
from easynlp_tpu_torch.ops.attention import attention

RESBLOCK_GN_EPS = 1e-5       # CompVis normalization(): GroupNorm32
TRANSFORMER_GN_EPS = 1e-6    # CompVis attention.py Normalize (fault 31)
TRANSFORMER_LN_EPS = 1e-5    # CompVis nn.LayerNorm's default (fault 32)
GEGLU_APPROXIMATE = "none"   # CompVis GEGLU's exact F.gelu (fault 30)


def timestep_embedding(timesteps, dim, max_period=10000.0):
    """Sinusoidal embedding [B] -> [B, dim] f32, cosines first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def linear(layer, x, dtype):
    """`layer` (an f32 nn.Linear) applied in `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    None if layer.bias is None else layer.bias.to(dtype))


def layer_norm(layer, x, dtype):
    """f32 LayerNorm, cast back to `dtype`."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(dtype)


class ResBlock(nn.Module):
    """GroupNorm, SiLU, conv; + the timestep projection; GroupNorm, SiLU,
    conv; a 1x1 skip where the width changes."""

    def __init__(self, in_channels, out_channels, temb_channels,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.in_layers = nn.ModuleList([
            make_group_norm(in_channels, RESBLOCK_GN_EPS, device), nn.SiLU(),
            nn.Conv2d(in_channels, out_channels, 3, padding=1,
                      device=device)])
        self.emb_layers = nn.ModuleList([
            nn.SiLU(), nn.Linear(temb_channels, out_channels, device=device)])
        self.out_layers = nn.ModuleList([
            make_group_norm(out_channels, RESBLOCK_GN_EPS, device), nn.SiLU(),
            nn.Dropout(0.0),
            nn.Conv2d(out_channels, out_channels, 3, padding=1,
                      device=device)])
        self.skip_connection = (nn.Conv2d(in_channels, out_channels, 1,
                                          device=device)
                                if in_channels != out_channels else None)

    def forward(self, x, temb):
        dt = self.dtype
        h = conv2d(self.in_layers[2],
                   silu_to(group_norm(self.in_layers[0], x), dt), dt)
        t = linear(self.emb_layers[1], silu_to(temb.float(), dt), dt)
        h = h + t[:, :, None, None]
        h = conv2d(self.out_layers[3],
                   silu_to(group_norm(self.out_layers[0], h), dt), dt)
        if self.skip_connection is not None:
            x = conv2d(self.skip_connection, x, dt)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, device=None):
        super().__init__()
        self.to_q = nn.Linear(query_dim, query_dim, bias=False, device=device)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False,
                              device=device)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False,
                              device=device)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim,
                                               device=device),
                                     nn.Dropout(0.0)])


class GEGLU(nn.Module):
    """proj -> [x, gate] halves -> x * gelu(gate)."""

    def __init__(self, dim, inner, device=None):
        super().__init__()
        self.approximate = GEGLU_APPROXIMATE
        self.proj = nn.Linear(dim, 2 * inner, device=device)

    def forward(self, x, dtype):
        h, gate = linear(self.proj, x, dtype).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate=self.approximate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, device=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, mult * dim, device),
                                  nn.Dropout(0.0),
                                  nn.Linear(mult * dim, dim, device=device)])


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, context_dim, device=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, device)
        self.ff = FeedForward(dim, device=device)
        self.attn2 = CrossAttention(dim, context_dim, device)
        self.norm1 = nn.LayerNorm(dim, eps=TRANSFORMER_LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=TRANSFORMER_LN_EPS, device=device)
        self.norm3 = nn.LayerNorm(dim, eps=TRANSFORMER_LN_EPS, device=device)


class SpatialTransformer(nn.Module):
    """GroupNorm and a 1x1 proj_in over the grid's H*W tokens; then
    self-attention, cross-attention to the text context and the gated
    MLP, each with a residual; a 1x1 proj_out and the outer residual."""

    def __init__(self, channels, num_heads, context_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.norm = make_group_norm(channels, TRANSFORMER_GN_EPS, device)
        self.proj_in = nn.Conv2d(channels, channels, 1, device=device)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, context_dim, device)])
        self.proj_out = nn.Conv2d(channels, channels, 1, device=device)

    def forward(self, x, context=None, share_self=None, cross_frame=False):
        """share_self (None, or a bool or 0-d bool tensor): where true, the
        second half of the batch takes the first half's self-attention
        probabilities (FreePromptEditing's map sharing; an explicit
        softmax, as JAX's, not a kernel). cross_frame: the self-attention
        runs over the whole batch of frames as one sequence."""
        dt = self.dtype
        blk = self.transformer_blocks[0]
        b, c, hh, ww = x.shape
        n, heads = hh * ww, self.num_heads
        d = c // heads
        h = conv2d(self.proj_in, group_norm(self.norm, x).to(dt), dt)
        h = h.flatten(2).transpose(1, 2)  # [B, H*W, C]

        normed = layer_norm(blk.norm1, h, dt)
        q, k, v = (linear(layer, normed, dt).view(b, n, heads, d)
                   for layer in (blk.attn1.to_q, blk.attn1.to_k,
                                 blk.attn1.to_v))
        if cross_frame:
            ctx = attention(q.reshape(1, b * n, heads, d),
                            k.reshape(1, b * n, heads, d),
                            v.reshape(1, b * n, heads, d))
        elif share_self is None:
            ctx = attention(q, k, v)
        else:
            ctx = _shared_self_attention(q, k, v, share_self)
        h = h + linear(blk.attn1.to_out[0], ctx.reshape(b, n, c), dt)

        if context is not None:
            normed = layer_norm(blk.norm2, h, dt)
            q = linear(blk.attn2.to_q, normed, dt).view(b, n, heads, d)
            kv_len = context.shape[1]
            k = linear(blk.attn2.to_k, context, dt).view(b, kv_len, heads, d)
            v = linear(blk.attn2.to_v, context, dt).view(b, kv_len, heads, d)
            ctx = attention(q, k, v)
            h = h + linear(blk.attn2.to_out[0], ctx.reshape(b, n, c), dt)

        normed = layer_norm(blk.norm3, h, dt)
        g = blk.ff.net[0](normed, dt)
        h = h + linear(blk.ff.net[2], g, dt)
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return x + conv2d(self.proj_out, h, dt)


def _shared_self_attention(q, k, v, share_self):
    """The explicit-probabilities self-attention of JAX's share_self path:
    f32 softmax(q k^T / sqrt(d)), the first half's maps copied onto the
    second half where `share_self` holds, cast to v's dtype, then P v."""
    b, d = q.shape[0], q.shape[-1]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, d]
    scores = (q @ k.transpose(-1, -2)).float() / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    half = b // 2
    shared = torch.cat([probs[:half], probs[:half]], dim=0)
    share = torch.as_tensor(share_self, device=q.device)
    probs = torch.where(share, shared, probs).to(v.dtype)
    return (probs @ v).transpose(1, 2)


class Downsample(nn.Module):
    """A stride-2 3x3 conv with one pixel of padding on every side (the
    UNet's, unlike the VAE's)."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1,
                            device=device)

    def forward(self, x, temb):
        return conv2d(self.op, x, self.dtype)


class Upsample(nn.Module):
    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x, temb):
        return conv2d(self.conv, F.interpolate(x, scale_factor=2,
                                               mode="nearest"), self.dtype)


def run_block(block, h, temb, context, share_self=None, cross_frame=False):
    """One input/middle/output block: its layers in order (ResBlock,
    SpatialTransformer, Up/Downsample)."""
    for layer in block:
        if isinstance(layer, SpatialTransformer):
            h = layer(h, context=context, share_self=share_self,
                      cross_frame=cross_frame)
        else:
            h = layer(h, temb)
    return h


def build_down_path(module, config, dtype, device):
    """The time embedding, input blocks and middle block shared by
    UNetModel and ControlNetModel. Returns the channel count of each skip
    (the input blocks' outputs, in order)."""
    ch = config.model_channels
    temb_ch = 4 * ch
    module.time_embed = nn.ModuleList([
        nn.Linear(ch, temb_ch, device=device), nn.SiLU(),
        nn.Linear(temb_ch, temb_ch, device=device)])
    module.input_blocks = nn.ModuleList([nn.ModuleList([
        nn.Conv2d(config.in_channels, ch, 3, padding=1, device=device)])])
    skips = [ch]
    c_in = ch
    mults = list(config.channel_mult)
    for level, mult in enumerate(mults):
        for _ in range(config.num_res_blocks):
            layers = [ResBlock(c_in, ch * mult, temb_ch, dtype, device)]
            c_in = ch * mult
            if level in config.attention_levels:
                layers.append(SpatialTransformer(c_in, config.num_heads,
                                                 config.context_dim, dtype,
                                                 device))
            module.input_blocks.append(nn.ModuleList(layers))
            skips.append(c_in)
        if level < len(mults) - 1:
            module.input_blocks.append(nn.ModuleList([
                Downsample(c_in, dtype, device)]))
            skips.append(c_in)
    module.middle_block = nn.ModuleList([
        ResBlock(c_in, c_in, temb_ch, dtype, device),
        SpatialTransformer(c_in, config.num_heads, config.context_dim, dtype,
                           device),
        ResBlock(c_in, c_in, temb_ch, dtype, device)])
    return skips


def time_embed(module, timesteps):
    """The f32 timestep MLP: Linear, SiLU, Linear."""
    emb = timestep_embedding(timesteps, module.time_embed[0].in_features)
    emb = module.time_embed[0](emb)
    return module.time_embed[2](F.silu(emb))


class UNetModel(nn.Module):
    """noise prediction eps [B, C, h, w] f32 from latents x [B, C, h, w],
    timesteps [B] and the text context [B, L, context_dim]. config:
    model_channels, channel_mult, num_res_blocks, attention_levels,
    num_heads, context_dim, in_channels, out_channels."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        skips = build_down_path(self, config, dtype, device)
        ch = config.model_channels
        temb_ch = 4 * ch
        mults = list(config.channel_mult)
        c_in = skips[-1]
        self.output_blocks = nn.ModuleList()
        for level in reversed(range(len(mults))):
            for blk in range(config.num_res_blocks + 1):
                layers = [ResBlock(c_in + skips.pop(), ch * mults[level],
                                   temb_ch, dtype, device)]
                c_in = ch * mults[level]
                if level in config.attention_levels:
                    layers.append(SpatialTransformer(
                        c_in, config.num_heads, config.context_dim, dtype,
                        device))
                if level and blk == config.num_res_blocks:
                    layers.append(Upsample(c_in, dtype, device))
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([
            make_group_norm(c_in, RESBLOCK_GN_EPS, device), nn.SiLU(),
            nn.Conv2d(c_in, config.out_channels, 3, padding=1,
                      device=device)])

    def forward(self, x, timesteps, context=None, share_self=None,
                cross_frame=False, control=None):
        """control: (down residuals aligned with the skips, the middle
        residual) from ControlNetModel, added onto the skip connections and
        the middle block's output."""
        dt = self.dtype
        temb = time_embed(self, timesteps)
        h = conv2d(self.input_blocks[0][0], x, dt)
        skips = [h]
        for block in self.input_blocks[1:]:
            h = run_block(block, h, temb, context, share_self, cross_frame)
            skips.append(h)
        h = run_block(self.middle_block, h, temb, context, share_self,
                      cross_frame)
        if control is not None:
            downs, mid = control
            if len(downs) != len(skips):
                raise ValueError("%d control residuals for %d skip "
                                 "connections" % (len(downs), len(skips)))
            skips = [s + r.to(s.dtype) for s, r in zip(skips, downs)]
            h = h + mid.to(h.dtype)
        for block in self.output_blocks:
            h = torch.cat([h, skips.pop()], dim=1)
            h = run_block(block, h, temb, context, share_self, cross_frame)
        h = silu_to(group_norm(self.out[0], h), dt)
        return conv2d(self.out[2], h, torch.float32)
