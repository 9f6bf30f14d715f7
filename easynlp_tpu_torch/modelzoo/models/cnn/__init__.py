from easynlp_tpu_torch.modelzoo.models.cnn.modeling_cnn import (  # noqa: F401
    TextCNNConfig,
    TextCNNModel,
)
