"""The generic seq2seq `transformer` (the open-domain-dialogue backbone) for
the PyTorch port (counterpart of
easynlp_tpu/modelzoo/models/transformer/modeling_transformer.py): the shared
encoder-decoder stack of bart/modeling_bart.py under TransformerConfig's
switches, generating through the shared generation loop. Its checkpoints
use BART's names (bart/conversion.py)."""

from easynlp_tpu_torch.modelzoo.models.bart.modeling_bart import (
    BartForConditionalGeneration,
)
from easynlp_tpu_torch.modelzoo.models.transformer.configuration_transformer import (  # noqa: F401
    TransformerConfig,
)


class TransformerGeneratorModel(BartForConditionalGeneration):
    config_class = TransformerConfig
