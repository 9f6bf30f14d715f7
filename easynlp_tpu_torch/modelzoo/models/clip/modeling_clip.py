"""CLIP dual tower for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/clip/modeling_clip.py
(`ViTBlock`, `ViTEncoder`, `CLIPModel`), with the same numerics:

- parameters are f32; projections compute in `dtype` (bf16 by default),
  LayerNorm in f32 and is cast back, the residual adds happen in `dtype`;
- the patch embedding is the JAX package's space-to-depth reshape and one
  [P*P*3] x E matmul (no bias) in `dtype`, from HF's conv weight
  [E, 3, P, P];
- integer (uint8) pixels [B, H, W, 3] are normalised inside the model,
  (x / 255 - mean) / std with the config's `image_mean`/`image_std` where
  given, else CLIP_MEAN/CLIP_STD; float pixels pass through unchanged;
- ViT attention is unmasked and goes through ops/attention.py (the short
  kernels on a card at 197 keys);
- `post_layernorm` normalises every token, so `last_hidden_state` is the
  normalised sequence and `pooler_output` its CLS row (the JAX encoder's
  outputs; HF normalises only the CLS row, which gives the same
  `pooler_output`);
- the projections run in f32 on the CLS rows, and the embeddings are
  L2-normalised with the JAX package's `+ 1e-8`.

Parameter names are HF ChineseCLIPModel's (`text_model.*` a BERT without
pooler, `vision_model.embeddings.{class_embedding, patch_embedding,
position_embedding}`, `vision_model.pre_layrnorm`,
`vision_model.encoder.layers.{i}.{layer_norm1, self_attn.{q,k,v,out}_proj,
layer_norm2, mlp.fc1, mlp.fc2}`, `vision_model.post_layernorm`,
`text_projection`, `visual_projection`, `logit_scale`), so an HF
Chinese-CLIP `pytorch_model.bin` loads with `load_state_dict` (conversion
.py). `--remat` checkpoints each ViT block as it does each BERT layer
(modeling_bert.REMAT_POLICIES).
"""

import torch
from torch import nn

from easynlp_tpu_torch.data.image_utils import CLIP_MEAN, CLIP_STD
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    BertModel,
    dense,
    init_bert_weights,
    layer_norm,
    remat_call,
)
from easynlp_tpu_torch.ops.attention import attention


class ViTAttention(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        e = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.q_proj = nn.Linear(e, e, device=device)
        self.k_proj = nn.Linear(e, e, device=device)
        self.v_proj = nn.Linear(e, e, device=device)
        self.out_proj = nn.Linear(e, e, device=device)

    def forward(self, x, dtype):
        b, s, e = x.shape
        h = self.num_heads
        q, k, v = (dense(p, x, dtype).view(b, s, h, e // h)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return dense(self.out_proj, attention(q, k, v).reshape(b, s, e),
                     dtype)


class ViTMLP(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        self.act = ACT2FN[config.hidden_act]
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             device=device)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             device=device)

    def forward(self, x, dtype):
        return dense(self.fc2, self.act(dense(self.fc1, x, dtype)), dtype)


class ViTBlock(nn.Module):
    """One pre-LN block. `remat` (modeling_bert.set_remat) is its --remat
    policy while it trains."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.remat = "none"
        eps = config.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=eps,
                                        device=device)
        self.self_attn = ViTAttention(config, device=device)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=eps,
                                        device=device)
        self.mlp = ViTMLP(config, device=device)

    def forward(self, hidden):
        if self.remat == "none" or not torch.is_grad_enabled():
            return self._block(hidden)
        return remat_call(self.remat, self._block, hidden)

    def _block(self, hidden):
        dt = self.dtype
        hidden = hidden + self.self_attn(
            layer_norm(self.layer_norm1, hidden, dt), dt)
        return hidden + self.mlp(layer_norm(self.layer_norm2, hidden, dt),
                                 dt)


class ViTEmbeddings(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        e, p = config.hidden_size, config.patch_size
        self.patch_size = p
        self.class_embedding = nn.Parameter(torch.empty(e, device=device))
        self.patch_embedding = nn.Conv2d(3, e, p, stride=p, bias=False,
                                         device=device)
        self.position_embedding = nn.Embedding(config.num_patches + 1, e,
                                               device=device)

    def forward(self, pixels, dtype):
        """pixels [B, H, W, 3] float -> [B, 1 + N, E] in dtype."""
        b, hh, ww, ch = pixels.shape
        p = self.patch_size
        x = pixels.reshape(b, hh // p, p, ww // p, p, ch).permute(
            0, 1, 3, 2, 4, 5).reshape(b, (hh // p) * (ww // p), p * p * ch)
        # HF's conv weight [E, 3, P, P] as the JAX kernel's rows (P, P, 3)
        w = self.patch_embedding.weight.permute(0, 2, 3, 1).reshape(
            -1, p * p * ch)
        x = torch.matmul(x.to(dtype), w.to(dtype).t())
        cls = self.class_embedding.to(dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[:x.shape[1]].to(dtype)


class ViTTransformer(nn.Module):
    """HF's `encoder`: the blocks, under `layers`."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            ViTBlock(config, dtype=dtype, device=device)
            for _ in range(config.num_hidden_layers))


class ViTEncoder(nn.Module):
    """pixels [B, H, W, 3] -> {'last_hidden_state': [B, 1 + N, E],
    'pooler_output': [B, E]}, both in `dtype`."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        eps = config.layer_norm_eps
        self.embeddings = ViTEmbeddings(config, device=device)
        self.pre_layrnorm = nn.LayerNorm(config.hidden_size, eps=eps,
                                         device=device)
        self.encoder = ViTTransformer(config, dtype=dtype, device=device)
        self.post_layernorm = nn.LayerNorm(config.hidden_size, eps=eps,
                                           device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal(initializer_range) kernels, embeddings and the
        class embedding, zero biases, unit LayerNorm scales, drawn from
        `generator` in module order."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, ViTEmbeddings):
                truncated_normal_(m.class_embedding, std, generator)
            if isinstance(m, (nn.Linear, nn.Embedding, nn.Conv2d)):
                truncated_normal_(m.weight, std, generator)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def normalize(self, pixels):
        """uint8 (any integer) pixels -> (x / 255 - mean) / std in f32,
        with the config's image_mean/image_std where set; floats as
        given."""
        if pixels.is_floating_point():
            return pixels
        c = self.config
        m, s = getattr(c, "image_mean", None), getattr(c, "image_std", None)
        mean = torch.tensor(CLIP_MEAN if m is None else m,
                            dtype=torch.float32, device=pixels.device)
        std = torch.tensor(CLIP_STD if s is None else s,
                           dtype=torch.float32, device=pixels.device)
        return (pixels.float() / 255.0 - mean) / std

    def forward(self, pixel_values):
        dt = self.dtype
        x = self.embeddings(self.normalize(pixel_values), dt)
        x = layer_norm(self.pre_layrnorm, x, dt)
        for block in self.encoder.layers:
            x = block(x)
        x = self.post_layernorm(x.float())
        return {"last_hidden_state": x.to(dt), "pooler_output": x[:, 0].to(dt)}


def l2_normalize(x):
    """x / (||x|| + 1e-8) over the last axis, as the JAX towers."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class CLIPModel(nn.Module):
    """The dual tower. forward returns the normalised f32 `text_embeds`
    and/or `image_embeds` and, with both, `logits_per_text` =
    exp(logit_scale) * text @ image^T and its transpose
    `logits_per_image`."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.text_model = BertModel(config.text_config, dtype=dtype,
                                    add_pooling_layer=False, device=device)
        self.vision_model = ViTEncoder(config.vision_config, dtype=dtype,
                                       device=device)
        self.text_projection = nn.Linear(config.text_config.hidden_size,
                                         config.projection_dim, bias=False,
                                         device=device)
        self.visual_projection = nn.Linear(
            config.vision_config.hidden_size, config.projection_dim,
            bias=False, device=device)
        self.logit_scale = nn.Parameter(torch.full(
            (), float(config.logit_scale_init_value), device=device))

    @torch.no_grad()
    def init_weights(self, generator):
        """The text tower's BERT init, the vision tower's, then
        truncated-normal(0.02) projections; logit_scale at the config's
        logit_scale_init_value."""
        init_bert_weights(self.text_model,
                          self.config.text_config.initializer_range,
                          generator)
        self.vision_model.init_weights(generator)
        truncated_normal_(self.text_projection.weight, 0.02, generator)
        truncated_normal_(self.visual_projection.weight, 0.02, generator)
        self.logit_scale.fill_(float(self.config.logit_scale_init_value))

    def get_text_features(self, input_ids, attention_mask=None,
                          token_type_ids=None):
        out = self.text_model(input_ids, attention_mask=attention_mask,
                              token_type_ids=token_type_ids)
        return l2_normalize(self.text_projection(
            out["last_hidden_state"][:, 0].float()))

    def get_image_features(self, pixel_values):
        out = self.vision_model(pixel_values)
        return l2_normalize(self.visual_projection(
            out["pooler_output"].float()))

    def forward(self, input_ids=None, attention_mask=None,
                token_type_ids=None, pixel_values=None):
        out = {}
        if input_ids is not None:
            out["text_embeds"] = self.get_text_features(
                input_ids, attention_mask, token_type_ids)
        if pixel_values is not None:
            out["image_embeds"] = self.get_image_features(pixel_values)
        if "text_embeds" in out and "image_embeds" in out:
            out["logits_per_text"] = torch.exp(self.logit_scale) * (
                out["text_embeds"] @ out["image_embeds"].t())
            out["logits_per_image"] = out["logits_per_text"].t()
        return out
