from easynlp_tpu_torch.modelzoo.models.glm.modeling_glm import (  # noqa: F401
    GLMConfig,
    GLMForConditionalGeneration,
    GLMModel,
    glm_attention_bias,
)
from easynlp_tpu_torch.modelzoo.models.glm.tokenization_glm import (  # noqa: F401
    GLMTokenizer,
)
