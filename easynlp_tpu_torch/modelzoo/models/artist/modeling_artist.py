"""ARTIST for the PyTorch port: a GPT over [text tokens; VQGAN image codes].

Counterpart of easynlp_tpu/modelzoo/models/artist/modeling_artist.py
(ARTISTConfig, VectorQuantizer, VQGANEncoder, VQGANDecoder, ARTISTModel),
with the same numerics:

- the VQGAN runs NCHW here (pixels enter and images leave as [B, H, W, 3],
  the JAX layout); its convolutions compute in the compute dtype with f32
  parameters, GroupNorm (the JAX `_gn`: 32 groups halved until they
  divide, eps 1e-6) and SiLU in f32, and the encoder's and decoder's last
  convs in f32. Down-sampling is JAX's stride-2 3x3 conv with one pixel
  of padding on every side, not taming's right-and-bottom pad (no JAX
  converter reads taming weights into ARTIST, so the port follows JAX;
  ROADMAP §C notes the departure beside reference fault 29); up-sampling
  is nearest 2x, then a conv. The JAX VQGAN has no middle block, no
  attention and no quant_conv, so neither has this one;
- the quantiser takes f32 distances |z|^2 - 2 z.C^T + |C|^2 and the first
  minimum (torch.argmin, as jnp.argmin), with the straight-through
  estimator and the codebook + commitment losses;
- the GPT is the port's GPT2Model (B1/B2 through ops/attention.py) over
  the joint vocabulary, text ids in [0, text_vocab) and image codes
  shifted into [text_vocab, text_vocab + image_vocab), with an untied f32
  `lm_head`;
- in training, `vq_loss` adds the reconstruction's MSE.

`image_first=True` orders the sequence [codes; text], the enable_vqgan
captioner's order. Parameter names keep the JAX module names
(`vq_encoder.down_0_res0.conv1`, `vq_decoder.up_1_us`, `quantizer.codebook`,
`gpt.h.0.attn.c_attn`, `lm_head`), the res blocks' 1x1 skip as
`nin_shortcut`, so `state_dict_from_jax` is a renaming and a transpose.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Config, GPT2Model
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    state_dict_from_jax as gpt2_state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import (
    KVCache,
    init_gpt2_weights,
)
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.autoencoder import (
    VAE_GN_EPS,
    VAEResBlock,
    conv2d,
    group_norm,
    init_module_weights,
    make_group_norm,
    silu_to,
)
from easynlp_tpu_torch.parallel import comm, sharding


class ARTISTConfig(PretrainedConfig):
    model_type = "artist"

    def __init__(self, text_vocab_size=21128, image_vocab_size=1024,
                 image_token_length=256, text_length=32, codebook_dim=64,
                 vq_channels=64, vq_channel_mult=(1, 2, 4),
                 vq_num_res_blocks=1, gpt_config=None, commitment_cost=0.25,
                 **kwargs):
        self.text_vocab_size = text_vocab_size
        self.image_vocab_size = image_vocab_size
        self.image_token_length = image_token_length
        self.text_length = text_length
        self.codebook_dim = codebook_dim
        self.vq_channels = vq_channels
        self.vq_channel_mult = tuple(vq_channel_mult)
        self.vq_num_res_blocks = vq_num_res_blocks
        self.commitment_cost = commitment_cost
        self.gpt_config_dict = gpt_config or {}
        super().__init__(**kwargs)

    @property
    def gpt_config(self):
        d = dict(self.gpt_config_dict)
        d.setdefault("vocab_size",
                     self.text_vocab_size + self.image_vocab_size)
        return GPT2Config(**d)


class VectorQuantizer(nn.Module):
    """Nearest codebook row per position, with the straight-through
    estimator. Over a tensor axis the codebook is split over its codes
    (JAX `("vocab", "kv")`): each rank takes the first minimum among its
    own rows, and the minimum over the ranks, the lowest global index on a
    tie, is jnp.argmin's code over the whole book; its row is looked up as
    a vocab-parallel embedding's."""

    def __init__(self, num_codes, code_dim, commitment_cost=0.25,
                 device=None):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(torch.empty(num_codes, code_dim,
                                                 device=device))
        self.group, self.start, self.num_codes = None, 0, num_codes

    def tensor_parallel_split(self, prefix, specs, mesh):
        """The codebook was split (sharding.apply_tensor_parallel): this
        rank holds codes [start, start + rows), padding rows past
        num_codes."""
        self.group = mesh.group("tensor")
        self.start = mesh.index("tensor") * self.codebook.shape[0]
        return {}

    def lookup(self, codes):
        """The codebook rows of codes (any shape) -> [..., D]."""
        if self.group is None:
            return self.codebook[codes]
        return sharding.vocab_parallel_lookup(self.codebook, codes,
                                              self.start, self.group)

    @torch.no_grad()
    def nearest(self, flat):
        """The code of each row of flat [N, D] f32: the first minimum of
        |z|^2 - 2 z.C^T + |C|^2 over the whole book."""
        cb = self.codebook.float()
        dist = (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ cb.t()
                + cb.pow(2).sum(1)[None])
        if self.group is None:
            return torch.argmin(dist, dim=-1)
        rows = torch.arange(self.start, self.start + cb.shape[0],
                            device=flat.device)
        dist = dist.masked_fill(rows[None] >= self.num_codes, float("inf"))
        best, code = dist.min(dim=-1)
        best = comm.all_gather(best[None].clone(), self.group)
        code = comm.all_gather((code + self.start)[None], self.group)
        lowest = best.min(dim=0, keepdim=True).values
        return torch.where(best == lowest, code,
                           torch.full_like(code, self.num_codes)).amin(0)

    def forward(self, z):
        """z [B, D, h, w] -> (quantised [B, D, h, w] f32 with the
        straight-through gradient, codes [B, h, w], vq_loss)."""
        b, d, h, w = z.shape
        z = z.float()
        flat = z.permute(0, 2, 3, 1).reshape(-1, d)
        codes = self.nearest(flat)
        quantised = self.lookup(codes).view(b, h, w, d).permute(0, 3, 1, 2)
        commit = torch.mean((quantised.detach() - z) ** 2)
        embed = torch.mean((quantised - z.detach()) ** 2)
        vq_loss = embed + self.commitment_cost * commit
        quantised = z + (quantised - z).detach()
        return quantised, codes.view(b, h, w), vq_loss


class VQGANEncoder(nn.Module):
    """pixels [B, 3, H, W] -> z [B, codebook_dim, H/f, W/f], f32."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        ch = config.vq_channels
        mults = list(config.vq_channel_mult)
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1, device=device)
        c_in = ch
        for level, mult in enumerate(mults):
            for blk in range(config.vq_num_res_blocks):
                self.add_module("down_%d_res%d" % (level, blk),
                                VAEResBlock(c_in, ch * mult, dtype, device))
                c_in = ch * mult
            if level < len(mults) - 1:
                self.add_module("down_%d_ds" % level, nn.Conv2d(
                    c_in, c_in, 3, stride=2, padding=1, device=device))
        self.norm_out = make_group_norm(c_in, VAE_GN_EPS, device)
        self.conv_out = nn.Conv2d(c_in, config.codebook_dim, 1, device=device)

    def forward(self, pixels):
        c, dt = self.config, self.dtype
        h = conv2d(self.conv_in, pixels, dt)
        for level in range(len(c.vq_channel_mult)):
            for blk in range(c.vq_num_res_blocks):
                h = getattr(self, "down_%d_res%d" % (level, blk))(h)
            if level < len(c.vq_channel_mult) - 1:
                h = conv2d(getattr(self, "down_%d_ds" % level), h, dt)
        h = silu_to(group_norm(self.norm_out, h), dt)
        return conv2d(self.conv_out, h, torch.float32)


class VQGANDecoder(nn.Module):
    """quantised [B, codebook_dim, h, w] -> pixels [B, 3, H, W], f32."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        ch = config.vq_channels
        mults = list(config.vq_channel_mult)
        c_in = ch * mults[-1]
        self.conv_in = nn.Conv2d(config.codebook_dim, c_in, 3, padding=1,
                                 device=device)
        for level in reversed(range(len(mults))):
            for blk in range(config.vq_num_res_blocks):
                self.add_module("up_%d_res%d" % (level, blk),
                                VAEResBlock(c_in, ch * mults[level], dtype,
                                            device))
                c_in = ch * mults[level]
            if level > 0:
                self.add_module("up_%d_us" % level, nn.Conv2d(
                    c_in, c_in, 3, padding=1, device=device))
        self.norm_out = make_group_norm(c_in, VAE_GN_EPS, device)
        self.conv_out = nn.Conv2d(c_in, 3, 3, padding=1, device=device)

    def forward(self, quantised):
        c, dt = self.config, self.dtype
        h = conv2d(self.conv_in, quantised, dt)
        for level in reversed(range(len(c.vq_channel_mult))):
            for blk in range(c.vq_num_res_blocks):
                h = getattr(self, "up_%d_res%d" % (level, blk))(h)
            if level > 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = conv2d(getattr(self, "up_%d_us" % level), h, dt)
        h = silu_to(group_norm(self.norm_out, h), dt)
        return conv2d(self.conv_out, h, torch.float32)


class ARTISTModel(nn.Module):
    """text ids + pixels (or codes) -> the GPT's logits over the joint
    [text; image-code] sequence (or [codes; text] with image_first), and
    the VQGAN's tokenize/decode."""

    tensor_table = "artist"

    def __init__(self, config, dtype=torch.float32, device=None,
                 image_first=False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.image_first = image_first
        gc = config.gpt_config
        self.gpt_config = gc
        self.vq_encoder = VQGANEncoder(config, dtype, device)
        self.vq_decoder = VQGANDecoder(config, dtype, device)
        self.quantizer = VectorQuantizer(config.image_vocab_size,
                                         config.codebook_dim,
                                         config.commitment_cost, device)
        self.gpt = GPT2Model(gc, dtype=dtype, device=device)
        self.lm_head = nn.Linear(gc.n_embd, gc.vocab_size, bias=False,
                                 device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """The VQGAN's convs lecun-normal with zero biases and unit
        GroupNorms, the codebook uniform(+-sqrt(3 / num_codes)) (flax's
        variance_scaling(1, fan_in, uniform) over [num_codes, dim]), then
        GPT-2's init and a truncated-normal(0.02) head."""
        init_module_weights(self.vq_encoder, generator)
        init_module_weights(self.vq_decoder, generator)
        limit = float(np.sqrt(3.0 / self.config.image_vocab_size))
        self.quantizer.codebook.uniform_(-limit, limit, generator=generator)
        init_gpt2_weights(self.gpt, self.gpt_config.initializer_range,
                          generator)
        truncated_normal_(self.lm_head.weight, 0.02, generator)

    def tokenize_image(self, pixel_values):
        """pixels [B, H, W, 3] in [-1, 1] -> (codes [B, h, w], vq_loss,
        quantised [B, D, h, w])."""
        z = self.vq_encoder(pixel_values.permute(0, 3, 1, 2))
        quantised, codes, vq_loss = self.quantizer(z)
        return codes, vq_loss, quantised

    def decode_codes(self, codes):
        """codes [B, h, w] -> pixels [B, H, W, 3] (f32, unclipped)."""
        quantised = self.quantizer.lookup(codes.long()).permute(0, 3, 1, 2)
        return self.vq_decoder(quantised).permute(0, 2, 3, 1)

    def lm_logits(self, hidden):
        """The f32 head (JAX's Dense with dtype f32), column-parallel over
        the vocabulary on a tensor axis (its columns gathered)."""
        return sharding.linear(self.lm_head, hidden.float(), torch.float32)

    def init_lm_cache(self, batch_size, max_length):
        gc = self.gpt_config
        device = self.lm_head.weight.device
        # the rank's own heads over a tensor axis
        shape = (batch_size, max_length, self.gpt.h[0].attn.num_heads,
                 gc.n_embd // gc.n_head)
        return KVCache(
            [torch.zeros(shape, dtype=self.dtype, device=device)
             for _ in range(gc.n_layer)],
            [torch.zeros(shape, dtype=self.dtype, device=device)
             for _ in range(gc.n_layer)],
            torch.zeros((batch_size, max_length), dtype=torch.int32,
                        device=device))

    def lm_step(self, input_ids, attention_mask=None, position_ids=None,
                cache=None):
        """GPT + head over raw joint-vocabulary ids (the prefill and decode
        steps of sampling): {'logits', 'cache'}."""
        out = self.gpt(input_ids=input_ids, attention_mask=attention_mask,
                       position_ids=position_ids, cache=cache)
        result = {"logits": self.lm_logits(out["last_hidden_state"])}
        if "cache" in out:
            result["cache"] = out["cache"]
        return result

    def forward(self, input_ids, pixel_values=None, image_codes=None,
                attention_mask=None):
        """{'logits' [B, S, V] f32, 'sequence' [B, S], 'vq_loss',
        'image_codes' [B, L], and 'reconstruction' [B, H, W, 3] where the
        pixels were tokenized here}."""
        c = self.config
        vq_loss = torch.zeros((), device=input_ids.device)
        recon = None
        if image_codes is None:
            codes, vq_loss, quantised = self.tokenize_image(pixel_values)
            image_codes = codes.reshape(input_ids.shape[0], -1)
            recon = self.vq_decoder(quantised).permute(0, 2, 3, 1)
            vq_loss = vq_loss + torch.mean(
                (recon.float() - pixel_values.float()) ** 2)
        text_mask = (attention_mask if attention_mask is not None
                     else torch.ones_like(input_ids)).to(torch.int32)
        img_mask = torch.ones(image_codes.shape, dtype=torch.int32,
                              device=input_ids.device)
        img_ids = (image_codes + c.text_vocab_size).to(input_ids.dtype)
        if self.image_first:
            seq = torch.cat([img_ids, input_ids], dim=1)
            mask = torch.cat([img_mask, text_mask], dim=1)
        else:
            seq = torch.cat([input_ids, img_ids], dim=1)
            mask = torch.cat([text_mask, img_mask], dim=1)
        out = self.gpt(input_ids=seq, attention_mask=mask)
        result = {"logits": self.lm_logits(out["last_hidden_state"]),
                  "sequence": seq, "vq_loss": vq_loss,
                  "image_codes": image_codes}
        if recon is not None:
            result["reconstruction"] = recon
        return result


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _conv(out, key, p):
    """A flax Conv (HWIO kernel) -> an nn.Conv2d's OIHW weight and bias."""
    out[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[key + ".bias"] = _t(p["bias"])


def _norm(out, key, p):
    out[key + ".weight"] = _t(p["scale"])
    out[key + ".bias"] = _t(p["bias"])


def _vqgan(out, prefix, p):
    """One VQGAN tower's tree: convs and norms by their JAX names, a res
    block's `skip` as `nin_shortcut`."""
    for name, sub in p.items():
        key = prefix + name
        if "_res" in name:
            _norm(out, key + ".norm1", sub["norm1"])
            _conv(out, key + ".conv1", sub["conv1"])
            _norm(out, key + ".norm2", sub["norm2"])
            _conv(out, key + ".conv2", sub["conv2"])
            if "skip" in sub:
                _conv(out, key + ".nin_shortcut", sub["skip"])
        elif name == "norm_out":
            _norm(out, key, sub)
        else:
            _conv(out, key, sub)


def state_dict_from_jax(params, config):
    """ARTISTModel's state dict from the JAX ARTISTModel's params (numpy
    leaves): the towers' convs HWIO -> OIHW, the GPT through GPT-2's
    converter (its scanned layers unstacked), the head's [E, V] kernel
    transposed."""
    state = {}
    _vqgan(state, "vq_encoder.", params["vq_encoder"])
    _vqgan(state, "vq_decoder.", params["vq_decoder"])
    state["quantizer.codebook"] = _t(params["quantizer"]["codebook"])
    state.update({"gpt." + k: v for k, v in gpt2_state_dict_from_jax(
        {"transformer": params["gpt"]}, config.gpt_config).items()})
    state["lm_head.weight"] = _t(np.asarray(params["lm_head"]["kernel"]).T)
    return state
