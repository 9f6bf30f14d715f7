"""Checkpoint names for the port's latent diffusion.

The port's modules carry CompVis's names (`model.diffusion_model.*`,
`first_stage_model.{encoder,decoder,quant_conv,post_quant_conv}.*`,
`cond_stage_model.transformer.*` for PAI-Diffusion's Chinese BERT text
tower), so a CompVis/PAI-Diffusion state dict needs only `normalize_keys`
(the `.ckpt`'s `state_dict` nesting, its schedule buffers and EMA copy
dropped, the text tower's prefixes unified). `state_dict_from_jax` goes the
other way from the JAX package's LDMModule tree: it is the inverse of
easynlp_tpu's `convert_sd_unet`/`convert_sd_vae` (HWIO kernels to OIHW,
Dense kernels to Linear weights or 1x1 convs, the fused `attn1_qkv` and
`attn2_kv` split, the GEGLU halves swapped back: JAX computes
gelu(g1) * g2 with g1 the gate half, CompVis x * gelu(gate) with chunks
[x, gate]) and of the BERT backbone conversion.
`controlnet_state_dict_from_jax` is the inverse of `convert_controlnet`
(`control_model.*` minus its prefix).

A text tower that is not BERT raises: the JAX `convert_stable_diffusion`
skips it silently and leaves a random text tower (ROADMAP reference fault
33).
"""

import numpy as np
import torch

from easynlp_tpu_torch.modelzoo.models.bert import conversion as bert_conv

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
TEXT_PREFIX = "cond_stage_model.transformer."
CONTROL_PREFIX = "control_model."
# the text tower's prefixes in CompVis/PAI-Diffusion checkpoints, as the
# JAX conversion reads them
_TEXT_PREFIXES = ("cond_stage_model.transformer.", "cond_stage_model.model.",
                  "cond_stage_model.")


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _conv(out, key, p):
    """A flax Conv (HWIO kernel) -> an nn.Conv2d's OIHW weight and bias."""
    out[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[key + ".bias"] = _t(p["bias"])


def _linear(out, key, p):
    out[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[key + ".bias"] = _t(p["bias"])


def _conv1_from_dense(out, key, p):
    """A Dense applied to a flattened grid -> a 1x1 conv."""
    out[key + ".weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    out[key + ".bias"] = _t(p["bias"])


def _norm(out, key, p):
    out[key + ".weight"] = _t(p["scale"])
    out[key + ".bias"] = _t(p["bias"])


def _resblock(out, base, p):
    _norm(out, base + "in_layers.0", p["norm1"])
    _conv(out, base + "in_layers.2", p["conv1"])
    _linear(out, base + "emb_layers.1", p["temb_proj"])
    _norm(out, base + "out_layers.0", p["norm2"])
    _conv(out, base + "out_layers.3", p["conv2"])
    if "skip" in p:
        _conv(out, base + "skip_connection", p["skip"])


def _spatial_transformer(out, base, p):
    tb = base + "transformer_blocks.0."
    _norm(out, base + "norm", p["norm"])
    _conv1_from_dense(out, base + "proj_in", p["proj_in"])
    qkv = np.asarray(p["attn1_qkv"]["kernel"])
    c = qkv.shape[1] // 3
    for i, name in enumerate(("to_q", "to_k", "to_v")):
        out[tb + "attn1.%s.weight" % name] = _t(qkv[:, i * c:(i + 1) * c].T)
    _linear(out, tb + "attn1.to_out.0", p["attn1_out"])
    _norm(out, tb + "norm1", p["ln1"])
    _linear(out, tb + "attn2.to_q", p["attn2_q"])
    kv = np.asarray(p["attn2_kv"]["kernel"])
    out[tb + "attn2.to_k.weight"] = _t(kv[:, :c].T)
    out[tb + "attn2.to_v.weight"] = _t(kv[:, c:].T)
    _linear(out, tb + "attn2.to_out.0", p["attn2_out"])
    _norm(out, tb + "norm2", p["ln2"])
    _norm(out, tb + "norm3", p["ln3"])
    # JAX's [gate | x] columns back to CompVis's [x; gate] rows
    w = np.asarray(p["mlp_in"]["kernel"])
    bias = np.asarray(p["mlp_in"]["bias"])
    half = w.shape[1] // 2
    out[tb + "ff.net.0.proj.weight"] = _t(
        np.concatenate([w[:, half:], w[:, :half]], axis=1).T)
    out[tb + "ff.net.0.proj.bias"] = _t(
        np.concatenate([bias[half:], bias[:half]]))
    _linear(out, tb + "ff.net.2", p["mlp_out"])
    _conv1_from_dense(out, base + "proj_out", p["proj_out"])


def _down_path(out, p, config):
    """time_embed, input_blocks and middle_block (UNet and ControlNet)."""
    _linear(out, "time_embed.0", p["temb_dense1"])
    _linear(out, "time_embed.2", p["temb_dense2"])
    _conv(out, "input_blocks.0.0", p["conv_in"])
    idx = 1
    for level in range(len(config.channel_mult)):
        for blk in range(config.num_res_blocks):
            base = "input_blocks.%d." % idx
            _resblock(out, base + "0.", p["down_%d_res%d" % (level, blk)])
            if level in config.attention_levels:
                _spatial_transformer(out, base + "1.",
                                     p["down_%d_attn%d" % (level, blk)])
            idx += 1
        if level < len(config.channel_mult) - 1:
            _conv(out, "input_blocks.%d.0.op" % idx,
                  p["down_%d_ds" % level])
            idx += 1
    _resblock(out, "middle_block.0.", p["mid_res1"])
    _spatial_transformer(out, "middle_block.1.", p["mid_attn"])
    _resblock(out, "middle_block.2.", p["mid_res2"])


def unet_state_dict_from_jax(p, config):
    """The port's UNetModel state dict from JAX's UNetModel tree."""
    out = {}
    _down_path(out, p, config)
    idx = 0
    for level in reversed(range(len(config.channel_mult))):
        for blk in range(config.num_res_blocks + 1):
            base = "output_blocks.%d." % idx
            _resblock(out, base + "0.", p["up_%d_res%d" % (level, blk)])
            sub = 1
            if level in config.attention_levels:
                _spatial_transformer(out, base + "%d." % sub,
                                     p["up_%d_attn%d" % (level, blk)])
                sub += 1
            if level and blk == config.num_res_blocks:
                _conv(out, base + "%d.conv" % sub, p["up_%d_us" % level])
            idx += 1
    _norm(out, "out.0", p["norm_out"])
    _conv(out, "out.2", p["conv_out"])
    return out


def _vae_resblock(out, base, p):
    _norm(out, base + "norm1", p["norm1"])
    _conv(out, base + "conv1", p["conv1"])
    _norm(out, base + "norm2", p["norm2"])
    _conv(out, base + "conv2", p["conv2"])
    if "skip" in p:
        _conv(out, base + "nin_shortcut", p["skip"])


def _vae_mid(out, base, p):
    _vae_resblock(out, base + "block_1.", p["mid_res1"])
    a = p["mid_attn"]
    _norm(out, base + "attn_1.norm", a["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(out, base + "attn_1." + name, a[name])
    _vae_resblock(out, base + "block_2.", p["mid_res2"])


def vae_state_dict_from_jax(enc, dec, config):
    """The port's AutoencoderKL state dict from JAX's VAEEncoder and
    VAEDecoder trees (quant_conv lives in the encoder's, post_quant_conv in
    the decoder's)."""
    out = {}
    levels = len(config.vae_channel_mult)
    _conv(out, "encoder.conv_in", enc["conv_in"])
    for level in range(levels):
        for blk in range(config.vae_num_res_blocks):
            _vae_resblock(out, "encoder.down.%d.block.%d." % (level, blk),
                          enc["down_%d_res%d" % (level, blk)])
        if "down_%d_ds" % level in enc:
            _conv(out, "encoder.down.%d.downsample.conv" % level,
                  enc["down_%d_ds" % level])
    _vae_mid(out, "encoder.mid.", enc)
    _norm(out, "encoder.norm_out", enc["norm_out"])
    _conv(out, "encoder.conv_out", enc["conv_out"])
    _conv(out, "quant_conv", enc["quant_conv"])
    _conv(out, "post_quant_conv", dec["post_quant_conv"])
    _conv(out, "decoder.conv_in", dec["conv_in"])
    _vae_mid(out, "decoder.mid.", dec)
    for level in range(levels):
        for blk in range(config.vae_num_res_blocks + 1):
            _vae_resblock(out, "decoder.up.%d.block.%d." % (level, blk),
                          dec["up_%d_res%d" % (level, blk)])
        if "up_%d_us" % level in dec:
            _conv(out, "decoder.up.%d.upsample.conv" % level,
                  dec["up_%d_us" % level])
    _norm(out, "decoder.norm_out", dec["norm_out"])
    _conv(out, "decoder.conv_out", dec["conv_out"])
    return out


def state_dict_from_jax(params, config):
    """The port's LDMModule state dict (CompVis names) from the JAX
    LDMModule tree with numpy leaves."""
    out = {UNET_PREFIX + k: v for k, v in
           unet_state_dict_from_jax(params["unet"], config).items()}
    out.update({VAE_PREFIX + k: v for k, v in vae_state_dict_from_jax(
        params["vae_encoder"], params["vae_decoder"], config).items()})
    out.update({TEXT_PREFIX + k: v for k, v in bert_conv.state_dict_from_jax(
        params["text_encoder"], config.text_config).items()})
    return out


def controlnet_state_dict_from_jax(p, config):
    """The port's ControlNetModel state dict from JAX's ControlNetModel
    tree: the UNet's down path plus `input_hint_block.{0,2,..,12}` (the hint
    ladder, SiLU between), `input_hint_block.14` (its zero conv out),
    `zero_convs.{i}.0` and `middle_block_out.0`."""
    out = {}
    _down_path(out, p, config)
    i = 0
    while "hint_conv_%d" % i in p:
        _conv(out, "input_hint_block.%d" % (2 * i), p["hint_conv_%d" % i])
        i += 1
    _conv(out, "input_hint_block.%d" % (2 * i), p["hint_conv_out"])
    z = 0
    while "zero_conv_%d" % z in p:
        _conv(out, "zero_convs.%d.0" % z, p["zero_conv_%d" % z])
        z += 1
    _conv(out, "middle_block_out.0", p["mid_out"])
    return out


def normalize_keys(state_dict):
    """A CompVis/PAI-Diffusion state dict (or a `.ckpt` dict holding one
    under "state_dict") under the port's names: the UNet, VAE and text
    tower keys kept, the text tower's prefix unified to
    `cond_stage_model.transformer.` with the BERT key rules (a `bert.`
    prefix, gamma/beta), everything else (schedule buffers, `model_ema.*`,
    the VAE's training loss) dropped. Raises where the text tower is not a
    BERT."""
    if "state_dict" in state_dict and isinstance(state_dict["state_dict"],
                                                  dict):
        state_dict = state_dict["state_dict"]
    out, text = {}, {}
    for k, v in state_dict.items():
        if k.startswith(UNET_PREFIX):
            out[k] = v
        elif k.startswith(VAE_PREFIX) and not k.startswith(
                VAE_PREFIX + "loss."):
            out[k] = v
        else:
            for prefix in _TEXT_PREFIXES:
                if k.startswith(prefix):
                    text[k[len(prefix):]] = v
                    break
    if text:
        backbone, other = bert_conv.split_backbone(
            bert_conv.normalize_keys(text), pooler=False)
        if "embeddings.word_embeddings.weight" not in backbone:
            raise ValueError(
                "the checkpoint's text tower (cond_stage_model.*, keys such "
                "as %s) is not a BERT; the port's latent diffusion reads "
                "PAI-Diffusion's BERT text tower only" % sorted(text)[:3])
        out.update({TEXT_PREFIX + k: v for k, v in backbone.items()})
    return out


def normalize_controlnet_keys(state_dict):
    """A ControlNet checkpoint's `control_model.*` keys without the
    prefix."""
    if "state_dict" in state_dict and isinstance(state_dict["state_dict"],
                                                  dict):
        state_dict = state_dict["state_dict"]
    return {k[len(CONTROL_PREFIX):] if k.startswith(CONTROL_PREFIX) else k: v
            for k, v in state_dict.items()}
