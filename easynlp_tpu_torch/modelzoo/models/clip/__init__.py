from easynlp_tpu_torch.modelzoo.models.clip.configuration_clip import (  # noqa: F401
    CLIPConfig,
    CLIPVisionConfig,
)
from easynlp_tpu_torch.modelzoo.models.clip.modeling_clip import (  # noqa: F401
    CLIPModel,
    ViTEncoder,
)
