from easynlp_tpu_torch.modelzoo.models.t5.configuration_t5 import (  # noqa: F401
    MT5Config,
    T5Config,
)
from easynlp_tpu_torch.modelzoo.models.t5.modeling_t5 import (  # noqa: F401
    T5ForConditionalGeneration,
)
from easynlp_tpu_torch.modelzoo.tokenization_sentencepiece import (  # noqa: F401
    MT5Tokenizer,
    T5Tokenizer,
)
