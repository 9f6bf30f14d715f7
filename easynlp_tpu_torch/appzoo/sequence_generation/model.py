"""Sequence generation application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_generation/model.py for two
backbones: GPT-2 (decoder-only; generation) and BART (encoder-decoder;
teacher-forced fine-tuning and generation). The app loads `config.json` and
`pytorch_model.bin` and generates with greedy, sampling or beam search
(modelzoo/generation_utils.py, through modelzoo/seq2seq_generation.py for
BART), optionally restricted to the tokens of each source row
(copy_constrained, a static vocab mask). Training computes the CE of the
decoder's logits against the labels (-100 ignored), as the JAX app does.
T5, mT5, Pegasus and Randeng are ROADMAP A18.
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo import generation_utils
from easynlp_tpu_torch.modelzoo.models import bart, gpt2
from easynlp_tpu_torch.modelzoo.models.auto import model_type_of
from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
    normalize_keys as bart_keys,
)
from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
    state_dict_from_jax as bart_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    normalize_keys as gpt2_keys,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
    state_dict_from_jax as gpt2_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)
from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
    encoder_decoder_generate,
)
from easynlp_tpu_torch.utils import losses

ENCODER_DECODER = ("t5", "mt5", "bart", "pegasus", "randeng")


class SequenceGeneration(Application):
    model_input_keys = ("input_ids", "attention_mask", "decoder_input_ids",
                        "decoder_attention_mask")

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        # the JAX app reads a config.json without model_type as t5
        model_type = model_type_of(model_dir) or "t5"
        if model_type == "gpt2":
            return gpt2.GPT2Config.from_pretrained(model_dir)
        if model_type == "bart":
            return bart.BartConfig.from_pretrained(model_dir)
        if model_type in ENCODER_DECODER:
            raise NotImplementedError(
                "sequence_generation on the encoder-decoder backbone %r is "
                "not ported yet (ROADMAP A18); the port has gpt2 and bart"
                % model_type)
        raise NotImplementedError(
            "sequence_generation has no backbone %r; the port has gpt2 and "
            "bart" % model_type)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        if config.is_encoder_decoder:
            return bart.BartForConditionalGeneration(config, dtype=dtype,
                                                     device=device)
        return gpt2.GPT2LMHeadModel(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        """Strictly, after HF key normalisation: for GPT-2 (into
        GPT2Model) the tied lm_head and HF's causal-mask buffers dropped;
        for BART the `model.` prefix, the shared embedding and
        final_logits_bias as bart/conversion.py sets out."""
        if module.config.is_encoder_decoder:
            module.load_state_dict(bart_keys(state_dict, module.config),
                                   strict=True)
        else:
            module.transformer.load_state_dict(gpt2_keys(state_dict),
                                               strict=True)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        if config.is_encoder_decoder:
            return bart_from_jax(params, config)
        return {"transformer." + k: v
                for k, v in gpt2_from_jax(params, config).items()}

    @staticmethod
    def loss_fn(outputs, batch):
        """Teacher-forced CE over the decoder labels (-100 on pads)."""
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["labels"],
                                             ignore_index=-100)}

    def export_state_dict(self):
        """The module's weights under the HF names (BART: `model.*` and
        final_logits_bias [1,V])."""
        return self.module.state_dict()

    def generate(self, src_ids, src_mask, max_length=64, num_beams=1,
                 do_sample=False, copy_constrained=False, **kwargs):
        """src_ids/src_mask [B, P] (numpy or tensors) -> token ids on the
        app's device.

        GPT-2, as in the JAX app: max_length counts NEW tokens (the
        reference's max_decoder_length), prompts are re-packed LEFT-padded to
        their batch width P with pad id `config.pad_token_id or 0`, and the
        result is [B, P + max_length] (or [B, N, P + max_length] for N
        returned beams). BART: the source is encoded as given and the result
        is the decoder's [B, max_length], its first column the decoder start
        token. copy_constrained bans every token absent from the row's source
        (EOS, pad and decoder-start ids stay allowed). kwargs go to
        generation_utils.generate (eos/pad ids default to the config's)."""
        src_np = np.asarray(torch.as_tensor(src_ids).cpu())
        mask_np = np.asarray(torch.as_tensor(src_mask).cpu())
        if self.config.is_encoder_decoder:
            ids, mask = src_np, mask_np
        else:
            prompts = [[int(t) for t, keep in zip(row, m) if keep]
                       for row, m in zip(src_np, mask_np)]
            pad_id = self.config.pad_token_id or 0
            ids, mask = generation_utils.left_pad(prompts, pad_id,
                                                  length=src_np.shape[1])
            max_length = src_np.shape[1] + max_length
        if copy_constrained:
            v = self.config.vocab_size
            allowed = np.zeros((ids.shape[0], v), bool)
            for i, row in enumerate(ids):
                allowed[i, row] = True
            for tid in (self.config.eos_token_id, self.config.pad_token_id,
                        getattr(self.config, "decoder_start_token_id", None)):
                if tid is not None and tid < v:
                    allowed[:, tid] = True
            if num_beams > 1:  # beam search flattens to [B*K, V]
                allowed = np.repeat(allowed, num_beams, axis=0)
            kwargs["bad_words_mask"] = torch.from_numpy(~allowed).to(
                self.device)
        if self.config.is_encoder_decoder:
            kwargs.pop("kv_cache", None)  # int8 KV is decoder-only (A16)
            with torch.inference_mode():
                return encoder_decoder_generate(
                    self.module,
                    torch.from_numpy(np.asarray(ids)).to(self.device,
                                                         torch.long),
                    torch.from_numpy(np.asarray(mask)).to(self.device),
                    max_length=max_length, num_beams=num_beams,
                    do_sample=do_sample, **kwargs)
        kwargs.setdefault("eos_token_id", self.config.eos_token_id)
        kwargs.setdefault("pad_token_id", pad_id)
        prefill, decode = make_gpt2_generation_fns(
            self.module, max_length, kv_cache=kwargs.pop("kv_cache", None))
        with torch.inference_mode():
            return generation_utils.generate(
                prefill, decode,
                torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device), max_length=max_length,
                num_beams=num_beams, do_sample=do_sample, **kwargs)
