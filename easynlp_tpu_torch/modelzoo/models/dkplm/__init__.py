from easynlp_tpu_torch.modelzoo.models.dkplm.modeling_dkplm import (  # noqa: F401
    DKPLMConfig,
    DKPLMForPreTraining,
    DKPLMModel,
    dkplm_pretrain_loss,
)
