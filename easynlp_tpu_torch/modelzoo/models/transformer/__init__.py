from easynlp_tpu_torch.modelzoo.models.transformer.configuration_transformer import (  # noqa: F401
    TransformerConfig,
)
from easynlp_tpu_torch.modelzoo.models.transformer.modeling_transformer import (  # noqa: F401
    TransformerGeneratorModel,
)
from easynlp_tpu_torch.modelzoo.models.transformer.tokenization_transformer import (  # noqa: F401
    TransformerTokenizer,
)
