from easynlp_tpu_torch.modelzoo.models.pegasus.modeling_pegasus import (  # noqa: F401
    PegasusConfig,
    PegasusForConditionalGeneration,
    convert_pegasus_state_dict,
)
from easynlp_tpu_torch.modelzoo.models.pegasus.tokenization_pegasus import (  # noqa: F401
    PegasusTokenizer,
)
