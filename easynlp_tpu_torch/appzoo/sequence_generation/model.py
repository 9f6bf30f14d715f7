"""Sequence generation application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_generation/model.py for its
decoder-only backbone, GPT-2: the app loads `config.json` and
`pytorch_model.bin` and generates with greedy, sampling or beam search
(modelzoo/generation_utils.py), optionally restricted to the tokens of each
source row (copy_constrained, a static vocab mask). The encoder-decoder
backbones (T5, mT5, BART, Pegasus, Randeng) are ROADMAP A18; training this
app is the next slice.
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo import generation_utils
from easynlp_tpu_torch.modelzoo.models.auto import model_type_of
from easynlp_tpu_torch.modelzoo.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import normalize_keys
from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
    make_gpt2_generation_fns,
)

ENCODER_DECODER = ("t5", "mt5", "bart", "pegasus", "randeng")


class SequenceGeneration(Application):
    model_input_keys = ("input_ids", "attention_mask")

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        # the JAX app reads a config.json without model_type as t5
        model_type = model_type_of(model_dir) or "t5"
        if model_type == "gpt2":
            return GPT2Config.from_pretrained(model_dir)
        if model_type in ENCODER_DECODER:
            raise NotImplementedError(
                "sequence_generation on the encoder-decoder backbone %r is "
                "not ported yet (ROADMAP A18); the port has gpt2"
                % model_type)
        raise NotImplementedError(
            "sequence_generation has no backbone %r; the port has gpt2"
            % model_type)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return GPT2LMHeadModel(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        """GPT2Model strictly, after HF key normalisation (the tied lm_head
        and HF's causal-mask buffers dropped)."""
        module.transformer.load_state_dict(normalize_keys(state_dict),
                                           strict=True)

    def generate(self, src_ids, src_mask, max_length=64, num_beams=1,
                 do_sample=False, copy_constrained=False, **kwargs):
        """src_ids/src_mask [B, P] (numpy or tensors; right- or left-padded)
        -> token ids [B, P + max_length] (or [B, N, P + max_length] for N
        returned beams) on the app's device.

        As in the JAX app: max_length counts NEW tokens (the reference's
        max_decoder_length), and prompts are re-packed LEFT-padded to their
        batch width P with pad id `config.pad_token_id or 0`.
        copy_constrained bans every token absent from the row's source (EOS,
        pad and decoder-start ids stay allowed). kwargs go to
        generation_utils.generate (eos/pad ids default to the config's)."""
        src_np = np.asarray(torch.as_tensor(src_ids).cpu())
        mask_np = np.asarray(torch.as_tensor(src_mask).cpu())
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
