"""Pegasus for the PyTorch port (counterpart of
easynlp_tpu/modelzoo/models/pegasus/modeling_pegasus.py).

Pegasus is the shared encoder-decoder stack of bart/modeling_bart.py under
PegasusConfig's switches: pre-LN blocks, the half-sin/half-cos position
table with no offset, sqrt(d_model) embedding scale, no embedding
LayerNorm and a final LayerNorm per stack. The class refuses a config
whose switches say otherwise, so an edited config cannot make a BART hybrid
that still loads Pegasus weights. HF Pegasus uses BART's parameter names,
so a checkpoint loads through bart/conversion.py (its sinusoidal tables
dropped).
"""

from easynlp_tpu_torch.modelzoo.models.bart.configuration_bart import (  # noqa: F401
    PegasusConfig,
)
from easynlp_tpu_torch.modelzoo.models.bart.conversion import normalize_keys
from easynlp_tpu_torch.modelzoo.models.bart.modeling_bart import (
    BartForConditionalGeneration,
)


class PegasusForConditionalGeneration(BartForConditionalGeneration):
    config_class = PegasusConfig

    def __init__(self, config, **kwargs):
        for switch, want in (("normalize_before", True),
                             ("position_type", "sinusoidal"),
                             ("final_layer_norm", True)):
            if getattr(config, switch) != want:
                raise ValueError("%s needs %s=%r, the config has %r"
                                 % (type(self).__name__, switch, want,
                                    getattr(config, switch)))
        super().__init__(config, **kwargs)


# The port's state dict from an HF Pegasus state dict: BART's names, the
# sinusoidal tables dropped (the JAX package's convert_pegasus_state_dict).
convert_pegasus_state_dict = normalize_keys
