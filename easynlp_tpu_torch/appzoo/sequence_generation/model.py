"""Sequence generation application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_generation/model.py over its
backbones: GPT-2 (decoder-only; generation and evaluation), and the
encoder-decoders BART, T5, mT5, Pegasus and Randeng (teacher-forced
fine-tuning, evaluation and generation), with the dialogue `transformer`
for open_domain_dialogue. The app loads `config.json` and
`pytorch_model.bin` (or the JAX package's `flax_params.msgpack` through
the family's state_dict_from_jax) and generates with greedy, sampling or
beam search (modelzoo/generation_utils.py, through
modelzoo/seq2seq_generation.py for the encoder-decoders), optionally
restricted to the tokens of each source row (copy_constrained, a static
vocab mask). Training computes the CE of the decoder's logits against the
labels (-100 ignored), as the JAX app does.

The JAX app builds Pegasus and Randeng as BartForConditionalGeneration
under their configs, as here. Its backbone table has no `transformer`
(ROADMAP reference fault 24); the port's has.
"""

import importlib

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo import generation_utils
from easynlp_tpu_torch.modelzoo.models.auto import model_type_of
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)
from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
    encoder_decoder_generate,
)
from easynlp_tpu_torch.utils import losses

_M = "easynlp_tpu_torch.modelzoo.models."
# model_type -> (module, config class, model class, conversion module), the
# JAX app's BACKBONES (easynlp_tpu appzoo/sequence_generation/model.py:16-29)
# with `transformer` added
BACKBONES = {
    "gpt2": ("gpt2", "GPT2Config", "GPT2LMHeadModel", "gpt2.conversion"),
    "bart": ("bart", "BartConfig", "BartForConditionalGeneration",
             "bart.conversion"),
    "pegasus": ("bart", "PegasusConfig", "BartForConditionalGeneration",
                "bart.conversion"),
    "randeng": ("bart", "RandengConfig", "BartForConditionalGeneration",
                "bart.conversion"),
    "transformer": ("transformer", "TransformerConfig",
                    "TransformerGeneratorModel", "bart.conversion"),
    "t5": ("t5", "T5Config", "T5ForConditionalGeneration", "t5.conversion"),
    "mt5": ("t5", "MT5Config", "T5ForConditionalGeneration",
            "t5.conversion"),
}


def backbone(model_type):
    """(config class, model class, conversion module) of a backbone."""
    if model_type not in BACKBONES:
        raise NotImplementedError(
            "sequence_generation has no backbone %r; the port has %s"
            % (model_type, ", ".join(BACKBONES)))
    module, config_cls, model_cls, conversion = BACKBONES[model_type]
    module = importlib.import_module(_M + module)
    return (getattr(module, config_cls), getattr(module, model_cls),
            importlib.import_module(_M + conversion))


class SequenceGeneration(Application):
    model_input_keys = ("input_ids", "attention_mask", "decoder_input_ids",
                        "decoder_attention_mask")

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        # the JAX app reads a config.json without model_type as t5
        config_cls, _, _ = backbone(model_type_of(model_dir) or "t5")
        return config_cls.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        _, model_cls, _ = backbone(config.model_type)
        return model_cls(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        """Strictly, after the family's HF key normalisation: for GPT-2
        (into GPT2Model) the tied lm_head and HF's causal-mask buffers
        dropped; for the BART family the `model.` prefix, the shared
        embedding, final_logits_bias and the sinusoidal tables as
        bart/conversion.py sets out; for T5 the stacks' embedding copies
        and the tied lm_head dropped (t5/conversion.py)."""
        config = module.config
        _, _, conversion = backbone(config.model_type)
        if config.model_type == "gpt2":
            module.transformer.load_state_dict(
                conversion.normalize_keys(state_dict), strict=True)
        else:
            module.load_state_dict(conversion.normalize_keys(state_dict,
                                                             config),
                                   strict=True)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        _, _, conversion = backbone(config.model_type)
        state = conversion.state_dict_from_jax(params, config)
        if config.model_type == "gpt2":
            return {"transformer." + k: v for k, v in state.items()}
        return state

    @staticmethod
    def loss_fn(outputs, batch):
        """Teacher-forced CE over the decoder labels (-100 on pads); a MoE
        model adds its router load-balancing loss (already scaled by
        router_aux_loss_coef), as JAX model.py:56-59."""
        loss = losses.cross_entropy(outputs["logits"], batch["labels"],
                                    ignore_index=-100)
        out = {"loss": loss}
        if "moe_aux_loss" in outputs:
            out["moe_aux_loss"] = outputs["moe_aux_loss"]
            out["loss"] = loss + outputs["moe_aux_loss"]
        return out

    def generated_tokens(self, row, max_length):
        """The generated part of one row of generate(max_length=...): after
        the prompt (GPT-2: the row's last max_length slots are the new
        ones) or after the decoder start column (encoder-decoders), up to
        and including the first EOS. The slots after EOS hold the pad id,
        which for GPT-2 is 0, a real token ("!"; ROADMAP C9)."""
        p = 1 if self.config.is_encoder_decoder else len(row) - max_length
        out = [int(t) for t in row[p:]]
        eos = self.config.eos_token_id
        if eos in out:
            out = out[:out.index(eos) + 1]
        return out

    def export_state_dict(self):
        """The module's weights under the HF names (the BART family:
        `model.*` and final_logits_bias [1,V])."""
        return self.module.state_dict()

    def generate(self, src_ids, src_mask, max_length=64, num_beams=1,
                 do_sample=False, copy_constrained=False, **kwargs):
        """src_ids/src_mask [B, P] (numpy or tensors) -> token ids on the
        app's device.

        GPT-2, as in the JAX app: max_length counts NEW tokens (the
        reference's max_decoder_length), prompts are re-packed LEFT-padded to
        their batch width P with pad id `config.pad_token_id or 0`, and the
        result is [B, P + max_length] (or [B, N, P + max_length] for N
        returned beams). Encoder-decoders: the source is encoded as given
        and the result is the decoder's [B, max_length], its first column
        the decoder start token. copy_constrained bans every token absent
        from the row's source (EOS, pad and decoder-start ids stay
        allowed). kwargs go to generation_utils.generate (eos/pad ids
        default to the config's): speculative='prompt_lookup' with
        num_draft_tokens and ngram_size, and for GPT-2 kv_cache='int8' (the
        encoder-decoders drop it, as the JAX app does)."""
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
            # the int8 KV cache is GPT-2's only: dropped here, as in JAX
            kwargs.pop("kv_cache", None)
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
        slack = (kwargs.get("num_draft_tokens", 8) + 1
                 if kwargs.get("speculative") else 0)
        prefill, decode = make_gpt2_generation_fns(
            self.module, max_length, cache_slack=slack,
            kv_cache=kwargs.pop("kv_cache", None))
        with torch.inference_mode():
            return generation_utils.generate(
                prefill, decode,
                torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device), max_length=max_length,
                num_beams=num_beams, do_sample=do_sample, **kwargs)
