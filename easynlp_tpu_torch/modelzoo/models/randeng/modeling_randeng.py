"""Randeng (IDEA Fengshenbang) for the PyTorch port (counterpart of
easynlp_tpu/modelzoo/models/randeng/modeling_randeng.py): the Pegasus
architecture under RandengConfig, so the same stack and checkpoint keys as
pegasus/modeling_pegasus.py."""

from easynlp_tpu_torch.modelzoo.models.bart.configuration_bart import (  # noqa: F401
    RandengConfig,
)
from easynlp_tpu_torch.modelzoo.models.pegasus.modeling_pegasus import (
    PegasusForConditionalGeneration,
    convert_pegasus_state_dict,
)

convert_randeng_state_dict = convert_pegasus_state_dict


class RandengForConditionalGeneration(PegasusForConditionalGeneration):
    config_class = RandengConfig
