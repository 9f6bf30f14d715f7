from easynlp_tpu_torch.modelzoo.models.kangaroo.modeling_kangaroo import (  # noqa: F401
    KangarooConfig,
    KangarooForPreTraining,
    KangarooModel,
)
