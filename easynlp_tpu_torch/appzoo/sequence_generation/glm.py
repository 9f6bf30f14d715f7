"""GLM blank-infilling fine-tuning, generation and long-context scoring for
the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_generation/glm.py: the cloze
layout [src..., gMASK, sop, tgt..., eop] with 2-D positions (Part A
positions 0..n and block 0, Part B at the gMASK position with blocks
1..N), the app over GLMForConditionalGeneration (the CE of the logits
against the next-token labels of Part B), its generation through the
shared engine (modelzoo/generation_utils.py: greedy, sampling, beams,
prompt-lookup speculative decoding) and `stream_logits`, segment-wise
scoring with Transformer-XL memories.

The prefill attends with JAX's block-infilling bias (plain path); every
later step, a decode step or a shared-index verify chunk, takes the
kernels through the cache mask and causality at offset `index`
(models/glm/modeling_glm.py).
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.data.dataset import BaseDataset
from easynlp_tpu_torch.modelzoo import generation_utils
from easynlp_tpu_torch.modelzoo.models.glm import conversion
from easynlp_tpu_torch.modelzoo.models.glm.modeling_glm import (
    GLMConfig,
    GLMForConditionalGeneration,
)
from easynlp_tpu_torch.utils import losses
from easynlp_tpu_torch.utils.logger import logger

IGNORE = -100


class GLMSequenceGenerationDataset(BaseDataset):
    """Rows 'src<TAB>tgt' -> the GLM cloze layout [src..., gMASK, sop,
    tgt..., eop] padded to src_len + tgt_len + 3, with 2-D positions; the
    control ids come from the tokenizer unless user_defined_parameters
    name them (gmask_id, sop_id, eop_id, pad_id; src_len, tgt_len)."""

    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 max_target_length=32, input_schema=None, first_sequence=None,
                 second_sequence=None, label_name=None,
                 user_defined_parameters=None, **kwargs):
        for k in ("label_enumerate_values", "multi_label", "is_training",
                  "image_size"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer
        self.src_len = int(udp.get("src_len",
                                   max_seq_length - max_target_length - 2))
        self.tgt_len = int(udp.get("tgt_len", max_target_length))
        self.src_col = first_sequence
        self.tgt_col = second_sequence or label_name
        self.gmask_id = int(udp.get("gmask_id", getattr(
            tokenizer, "gmask_token_id", 1)))
        self.sop_id = int(udp.get("sop_id", getattr(
            tokenizer, "sop_token_id", 2)))
        self.eop_id = int(udp.get("eop_id", getattr(
            tokenizer, "eop_token_id", 3)))
        self.pad_id = int(udp.get("pad_id",
                                  getattr(tokenizer, "pad_token_id", 0)))
        self._build_features()

    def _encode(self, text, limit):
        ids = self.tokenizer([str(text)], max_length=limit)["input_ids"][0]
        return [t for t in ids if t != self.pad_id][:limit]

    def _build_features(self):
        s_total = self.src_len + 1 + 1 + self.tgt_len + 1
        rows = []
        for row in self.rows:
            r = self.parse_row(row)
            src = self._encode(r.get(self.src_col, ""), self.src_len)
            tgt = self._encode(r.get(self.tgt_col, ""), self.tgt_len) \
                if self.tgt_col else []
            n = len(src)
            part_a = src + [self.gmask_id]
            part_b = [self.sop_id] + tgt + [self.eop_id]
            ids = part_a + part_b
            pos = list(range(len(part_a))) + [n] * len(part_b)
            blocks = [0] * len(part_a) + list(range(1, len(part_b) + 1))
            # labels[i]: the token position i predicts (sop -> tgt0, ...,
            # tgt_last -> eop)
            labels = ([IGNORE] * len(part_a) + tgt + [self.eop_id]
                      + [IGNORE])[:len(ids)]
            pad = s_total - len(ids)
            rows.append({
                "input_ids": ids + [self.pad_id] * pad,
                "attention_mask": [1] * len(ids) + [0] * pad,
                "position_ids": pos + [0] * pad,
                "block_position_ids": blocks + [0] * pad,
                "labels": labels + [IGNORE] * pad,
                "prefix_lengths": len(part_a),
            })
        self.features = {
            k: np.asarray([r[k] for r in rows], np.int32) for k in rows[0]}

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}


def make_glm_generation_fns(model, max_length, cache_dtype=None,
                            cache_slack=0):
    """(prefill, decode) for prompts laid out [pad..., src, gMASK, sop]
    (LEFT-padded): Part B tokens take the gMASK position as position id and
    blocks 2, 3, ... after sop's 1. decode.chunk / decode.rollback serve
    speculative decoding (cache_slack extra slots), prefill.reindex_cache
    beam search."""

    def prefill(input_ids, attention_mask):
        b, p = input_ids.shape
        cache = model.init_cache(b, max_length + cache_slack,
                                 dtype=cache_dtype)
        mask = attention_mask.to(torch.int32)
        cache.mask[:, :p] = mask
        mask_pos = mask.sum(-1) - 2                 # gMASK's position id
        pos = (mask.cumsum(-1) - 1).clamp(min=0)
        rev = mask.flip(-1).cumsum(-1).flip(-1)
        is_sop = (rev == 1) & (mask > 0)             # the last real slot
        positions = torch.where(is_sop, mask_pos[:, None], pos)
        blocks = is_sop.to(torch.long)
        cache.glm_mask_pos = mask_pos
        cache.glm_prompt_len = p
        cache.prefix_len = p - 1
        out = model(input_ids, position_ids=positions,
                    block_position_ids=blocks,
                    prefix_lengths=torch.full((b,), p - 1, dtype=torch.long,
                                              device=input_ids.device),
                    cache=cache)
        return out["logits"][:, -1].float(), out["cache"]

    def _step(tokens, cache):
        b, s = tokens.shape
        idx = cache.index
        cache.mask[:, idx:idx + s] = 1
        positions = cache.glm_mask_pos[:, None].expand(b, s)
        blocks = (idx - cache.glm_prompt_len + 2
                  + torch.arange(s, device=tokens.device)).expand(b, s)
        out = model(tokens, position_ids=positions, block_position_ids=blocks,
                    prefix_lengths=torch.full(
                        (b,), cache.glm_prompt_len - 1, dtype=torch.long,
                        device=tokens.device),
                    cache=cache)
        return out["logits"].float(), out["cache"]

    def decode(token, cache):
        logits, cache = _step(token, cache)
        return logits[:, -1], cache

    def decode_chunk(tokens, cache):
        """Speculative verify: [B, S] tokens at the shared index, logits of
        all S positions, Part B's 2-D positions extended per offset."""
        return _step(tokens, cache)

    def rollback(cache, drop):
        cache.index -= drop
        cache.mask[:, cache.index:] = 0
        return cache

    def reindex_cache(cache, rows):
        new = cache.reindex(rows)
        new.glm_mask_pos = cache.glm_mask_pos.index_select(0, rows)
        new.glm_prompt_len = cache.glm_prompt_len
        return new

    prefill.reindex_cache = reindex_cache
    decode.chunk = decode_chunk
    decode.rollback = rollback
    decode.cache_slack = cache_slack
    return prefill, decode


class GLMSequenceGeneration(Application):
    model_input_keys = ("input_ids", "position_ids", "block_position_ids",
                        "prefix_lengths", "attention_mask")

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["labels"],
                                             ignore_index=IGNORE)}

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return GLMConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return GLMForConditionalGeneration(config, dtype=dtype,
                                           device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        """A reference or Megatron checkpoint, strictly
        (conversion.normalize_keys)."""
        module.load_state_dict(conversion.normalize_keys(state_dict),
                               strict=True)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return conversion.state_dict_from_jax(params, config)

    def export_state_dict(self):
        return self.module.state_dict()

    def generated_tokens(self, row, max_length):
        """generate() returns the generated slots only; the slots after
        eop hold the pad id."""
        return [int(t) for t in row]

    def stream_logits(self, input_ids, attention_mask=None,
                      segment_length=64, mem_length=None):
        """Causal scoring of a long sequence in segments with Transformer-XL
        memories (each segment sees the last `mem_length` positions of the
        earlier ones through their layer inputs): f32 logits [B, T, V] on
        the app's device; T must divide into segment_length."""
        ids = torch.as_tensor(np.asarray(input_ids)).to(self.device).long()
        b, t = ids.shape
        if t % segment_length:
            raise ValueError("sequence length %d must divide into "
                             "segment_length %d" % (t, segment_length))
        mem_length = int(mem_length if mem_length is not None
                         else getattr(self.config, "max_memory_length", 0)
                         or segment_length)
        mask = (torch.as_tensor(np.asarray(attention_mask)).to(self.device)
                if attention_mask is not None
                else torch.ones((b, t), dtype=torch.int32,
                                device=self.device))
        chunks = []
        with torch.inference_mode():
            mems = self.module.init_mems(b, mem_length)
            for off in range(0, t, segment_length):
                seg = ids[:, off:off + segment_length]
                pos = off + torch.arange(seg.shape[1], device=self.device)
                out = self.module(
                    seg, position_ids=pos.expand_as(seg),
                    block_position_ids=torch.zeros_like(seg),
                    prefix_lengths=torch.zeros((b,), dtype=torch.long,
                                               device=self.device),
                    attention_mask=mask[:, off:off + segment_length],
                    mems=mems)
                mems = out["mems"]
                chunks.append(out["logits"].float())
        return torch.cat(chunks, dim=1)

    def generate(self, src_ids, src_mask, max_length=32, gmask_id=1,
                 sop_id=2, eop_id=3, pad_id=0, num_beams=1, do_sample=False,
                 **kwargs):
        """Blank-infilling generation: [src, gMASK, sop] prompts left-padded,
        Part B decoded with the cache; returns the generated slots [B,
        max_length] (or [B, N, max_length] for N returned beams) on the
        app's device. The control ids must be the tokenizer's (the predictor
        and evaluator pass them: glm_special_ids)."""
        if kwargs.pop("kv_cache", None):
            logger.warning("kv_cache_dtype is not supported for the GLM "
                           "cache yet; serving with full-precision KV")
        src_np = np.asarray(torch.as_tensor(src_ids).cpu())
        mask_np = np.asarray(torch.as_tensor(src_mask).cpu())
        prompts = [[int(t) for t, keep in zip(row, m) if keep]
                   + [gmask_id, sop_id] for row, m in zip(src_np, mask_np)]
        ids, mask = generation_utils.left_pad(prompts, pad_id)
        p = ids.shape[1]
        total = p + max_length
        if kwargs.get("min_length"):
            # decoder-relative min length; the engine counts buffer slots
            kwargs["min_length"] = p + int(kwargs["min_length"])
        slack = (kwargs.get("num_draft_tokens", 8) + 1
                 if kwargs.get("speculative") else 0)
        prefill, decode = make_glm_generation_fns(self.module, total,
                                                  cache_slack=slack)
        with torch.inference_mode():
            seqs = generation_utils.generate(
                prefill, decode,
                torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device), max_length=total,
                num_beams=num_beams, do_sample=do_sample,
                eos_token_id=eop_id, pad_token_id=pad_id, **kwargs)
        return seqs[..., p:]
