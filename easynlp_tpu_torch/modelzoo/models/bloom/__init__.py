from easynlp_tpu_torch.modelzoo.models.bloom.modeling_bloom import (  # noqa: F401
    BloomConfig,
    BloomForCausalLM,
    BloomModel,
    alibi_bias,
    alibi_slopes,
)
