from easynlp_tpu_torch.modelzoo.models.gpt2.configuration_gpt2 import (  # noqa: F401
    GPT2Config,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import (  # noqa: F401
    GPT2LMHeadModel,
    GPT2Model,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (  # noqa: F401
    GPT2Tokenizer,
)
