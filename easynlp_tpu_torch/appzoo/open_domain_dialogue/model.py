"""Open-domain dialogue application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/open_domain_dialogue/model.py: context ->
response generation on the sequence_generation app, over the generic
`transformer` family (modelzoo/models/transformer/) or any other
encoder-decoder backbone. The loss is SequenceGeneration's: the per-token
CE over the response, -100 positions ignored and normalised by the real
target tokens (JAX's loss_fn, the same function); `chat` joins the turns
with " [SEP] " and decodes the generated reply.

The JAX app takes its backbones from the sequence_generation app's table,
which has no `transformer`, so it cannot load a transformer checkpoint
(ROADMAP reference fault 24); the port's table has it.
"""

import torch

from easynlp_tpu_torch.appzoo.sequence_generation.model import (
    SequenceGeneration,
)


class OpenDomainDialogue(SequenceGeneration):
    """Context -> response generation; a row's context is its turns joined
    by the dataset or by chat()."""

    def chat(self, history_texts, tokenizer, max_length=64, num_beams=3,
             **kwargs):
        """The reply to the turns history_texts (a list of strings)."""
        source = " [SEP] ".join(history_texts)
        enc = tokenizer([source], max_length=128)
        seqs = self.generate(torch.from_numpy(enc["input_ids"]),
                             torch.from_numpy(enc["attention_mask"]),
                             max_length=max_length, num_beams=num_beams,
                             **kwargs)
        return tokenizer.decode(seqs[0].cpu().tolist(),
                                skip_special_tokens=True)
