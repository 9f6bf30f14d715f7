from easynlp_tpu_torch.modelzoo.models.kbert.modeling_kbert import (  # noqa: F401
    KBertConfig,
    KBertModel,
)
