from easynlp_tpu_torch.modelzoo.models.randeng.modeling_randeng import (  # noqa: F401
    RandengConfig,
    RandengForConditionalGeneration,
    convert_randeng_state_dict,
)
from easynlp_tpu_torch.modelzoo.models.randeng.tokenization_randeng import (  # noqa: F401
    RandengTokenizer,
)
