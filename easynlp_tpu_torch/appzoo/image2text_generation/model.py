"""Image-to-text generation (captioning) for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/image2text_generation/model.py, its ViT
variant (the default and `enable_vit`; `enable_vqgan` is
vqgan_model.py's ARTIST tower): every token of the ViT's normalised
sequence, CLS included, goes through `visual_proj` into GPT-2's width and
sits before the caption as a prefix; the app owns the token table `wte` (the GPT's own is None) and
the LM head is that table, tied, plus `lm_bias`. Training is next-token
cross-entropy over the caption. `caption_prefill` and `caption_decode`
run the GPT over a KVCache whose slots [0, P) hold the visual prefix;
`CLIPGPTImageTextGeneration.generate` decodes greedy, with beams (each
image's pixels repeated per beam, as the JAX make_caption_generation_fns)
or by sampling, through modelzoo/generation_utils.py.

Parameter names: `vision.*` (the ViTEncoder's HF names), `gpt.*` (GPT-2's
HF names, no `wte`), `wte.weight`, `visual_proj.{weight, bias}`,
`lm_bias`.
"""

import numpy as np
import torch
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import dense
from easynlp_tpu_torch.modelzoo.models.clip import (
    CLIPVisionConfig,
    ViTEncoder,
)
from easynlp_tpu_torch.modelzoo.models.clip.conversion import (
    vision_state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Config, GPT2Model
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    state_dict_from_jax as gpt2_state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import (
    KVCache,
    init_gpt2_weights,
)
from easynlp_tpu_torch.utils import losses


class I2TConfig(PretrainedConfig):
    """The ViT and GPT-2 configs as dicts (`vision_config_dict`,
    `gpt_config_dict`), as the JAX I2TConfig writes and reads them."""
    model_type = "clip_gpt_i2t"

    def __init__(self, vision_config=None, gpt_config=None, **kwargs):
        self.vision_config_dict = vision_config or {}
        self.gpt_config_dict = gpt_config or {}
        super().__init__(**kwargs)

    @property
    def vision_config(self):
        return CLIPVisionConfig(**self.vision_config_dict)

    @property
    def gpt_config(self):
        return GPT2Config(**self.gpt_config_dict)


class CLIPGPTImageTextModule(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        vc, gc = config.vision_config, config.gpt_config
        self.gpt_config = gc
        self.vision = ViTEncoder(vc, dtype=dtype, device=device)
        self.gpt = GPT2Model(gc, dtype=dtype, device=device)
        self.gpt.wte = None  # the app's own table below takes its place
        self.wte = nn.Embedding(gc.vocab_size, gc.n_embd, device=device)
        self.visual_proj = nn.Linear(vc.hidden_size, gc.n_embd,
                                     device=device)
        self.lm_bias = nn.Parameter(torch.zeros(gc.vocab_size,
                                                device=device))

    @torch.no_grad()
    def init_weights(self, generator):
        """The ViT's init, GPT-2's (truncated-normal projections and
        positions, zero biases, unit LayerNorms), then the token table and
        visual_proj truncated-normal(0.02), zero biases."""
        self.vision.init_weights(generator)
        init_gpt2_weights(self.gpt, self.gpt_config.initializer_range,
                          generator)
        truncated_normal_(self.wte.weight, 0.02, generator)
        truncated_normal_(self.visual_proj.weight, 0.02, generator)
        self.visual_proj.bias.zero_()
        self.lm_bias.zero_()

    def prefix_length(self, pixel_values):
        """The visual prefix's length for these pixels."""
        return self.config.vision_config.num_patches + 1

    def encode_image(self, pixel_values):
        """Every ViT token, CLS included, in GPT-2's width: [B, P, E]."""
        out = self.vision(pixel_values)
        return dense(self.visual_proj, out["last_hidden_state"], self.dtype)

    def lm_logits(self, hidden):
        dt = self.dtype
        return torch.matmul(hidden, self.wte.weight.to(dt).t()) \
            + self.lm_bias.to(dt)

    def _prefixed(self, pixel_values, input_ids, attention_mask):
        """(the prefix and caption embeddings, their mask, P)."""
        prefix = self.encode_image(pixel_values).to(self.dtype)
        b, p, _ = prefix.shape
        text = self.wte(input_ids).to(self.dtype)
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.int32,
                                        device=input_ids.device)
        mask = torch.cat([torch.ones((b, p), dtype=torch.int32,
                                     device=input_ids.device),
                          attention_mask.to(torch.int32)], dim=1)
        return torch.cat([prefix, text], dim=1), mask, p

    def forward(self, pixel_values, input_ids, attention_mask=None):
        """{'logits': [B, S, V] over the caption's positions, 'prefix_len':
        P}."""
        embeds, mask, p = self._prefixed(pixel_values, input_ids,
                                         attention_mask)
        out = self.gpt(inputs_embeds=embeds, attention_mask=mask)
        return {"logits": self.lm_logits(out["last_hidden_state"][:, p:]),
                "prefix_len": p}

    def init_lm_cache(self, batch_size, max_length):
        gc = self.gpt_config
        device = self.wte.weight.device
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

    def caption_prefill(self, pixel_values, input_ids, attention_mask,
                        cache):
        """[visual prefix; prompt tokens] into the cache: (f32 logits
        [B, V] of the last position, the cache)."""
        embeds, mask, _ = self._prefixed(pixel_values, input_ids,
                                         attention_mask)
        out = self.gpt(inputs_embeds=embeds, attention_mask=mask,
                       cache=cache)
        return (self.lm_logits(out["last_hidden_state"][:, -1]).float(),
                out["cache"])

    def caption_decode(self, token, position_ids, cache):
        out = self.gpt(inputs_embeds=self.wte(token).to(self.dtype),
                       position_ids=position_ids,
                       attention_mask=torch.ones_like(token), cache=cache)
        return (self.lm_logits(out["last_hidden_state"][:, -1]).float(),
                out["cache"])


def make_caption_generation_fns(module, pixel_values, prefix_len,
                                cache_len):
    """(prefill, decode) for generation_utils over the visual prefix in
    cache slots [0, prefix_len); the token buffer holds the caption only.
    Beam search's batch of B * K rows repeats each image's pixels K
    times; prefill.reindex_cache gathers beams."""

    def prefill(input_ids, attention_mask):
        b, p = input_ids.shape
        pv = pixel_values
        if pv.shape[0] != b:
            pv = torch.repeat_interleave(pv, b // pv.shape[0], dim=0)
        cache = module.init_lm_cache(b, cache_len)
        cache.mask[:, :prefix_len] = 1
        cache.mask[:, prefix_len:prefix_len + p] = attention_mask
        return module.caption_prefill(pv, input_ids, attention_mask, cache)

    def decode(token, cache):
        positions = cache.mask.sum(dim=-1, keepdim=True)
        cache.mask[:, cache.index] = 1
        return module.caption_decode(token, positions, cache)

    prefill.reindex_cache = KVCache.reindex
    return prefill, decode


class CLIPGPTImageTextGeneration(Application):
    model_input_keys = ("pixel_values", "input_ids", "attention_mask")
    module_cls = CLIPGPTImageTextModule

    @staticmethod
    def loss_fn(outputs, batch):
        """Next-token cross-entropy over the caption's real tokens."""
        logits = outputs["logits"][:, :-1]
        labels = torch.where(batch["attention_mask"][:, 1:] > 0,
                             batch["input_ids"][:, 1:].long(), -100)
        return {"loss": losses.cross_entropy(logits, labels,
                                             ignore_index=-100)}

    def generate(self, pixel_values, max_length=32, bos_token_id=101,
                 eos_token_id=102, pad_token_id=0, num_beams=1,
                 do_sample=False, top_k=0, temperature=1.0, generator=None):
        """Caption ids [B, max_length] after the visual prefix, starting
        from bos_token_id."""
        from easynlp_tpu_torch.modelzoo.generation_utils import generate
        module = self.module
        pv = pixel_values if torch.is_tensor(pixel_values) \
            else torch.from_numpy(np.asarray(pixel_values))
        pv = pv.to(self.device)
        b = pv.shape[0]
        prefix_len = module.prefix_length(pv)
        prefill, decode = make_caption_generation_fns(
            module, pv, prefix_len, prefix_len + max_length)
        ids = torch.full((b, 1), bos_token_id, dtype=torch.int32,
                         device=self.device)
        mask = torch.ones((b, 1), dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            return generate(prefill, decode, ids, mask,
                            max_length=max_length, num_beams=num_beams,
                            do_sample=do_sample, top_k=top_k,
                            temperature=temperature,
                            eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id, generator=generator)

    def export_state_dict(self):
        return self.module.state_dict()

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return I2TConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return cls.module_cls(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        module.load_state_dict(state_dict, strict=True)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        """The module's state dict from the JAX app's params: `vision`
        (ViTEncoder), `gpt` (GPT2Model without wte), `wte`, `visual_proj`
        and `lm_bias`."""
        def t(x):
            return torch.tensor(np.asarray(x, dtype=np.float32))
        state = {"vision." + k: v for k, v in vision_state_dict_from_jax(
            params["vision"], config.vision_config).items()}
        state.update({"gpt." + k: v for k, v in gpt2_state_dict_from_jax(
            {"transformer": params["gpt"]}, config.gpt_config).items()})
        state["wte.weight"] = t(params["wte"]["embedding"])
        state["visual_proj.weight"] = t(
            np.asarray(params["visual_proj"]["kernel"]).T)
        state["visual_proj.bias"] = t(params["visual_proj"]["bias"])
        state["lm_bias"] = t(params["lm_bias"])
        return state
