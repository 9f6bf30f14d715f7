from easynlp_tpu_torch.modelzoo.models.bart.configuration_bart import (  # noqa: F401
    BartConfig,
    PegasusConfig,
    RandengConfig,
)
from easynlp_tpu_torch.modelzoo.models.bart.modeling_bart import (  # noqa: F401
    BartForConditionalGeneration,
)
from easynlp_tpu_torch.modelzoo.models.bart.tokenization_bart import (  # noqa: F401
    BartTokenizer,
)
