from easynlp_tpu_torch.modelzoo.models.bert.configuration_bert import (  # noqa: F401
    BertConfig,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (  # noqa: F401
    BertModel,
)
from easynlp_tpu_torch.modelzoo.models.bert.tokenization_bert import (  # noqa: F401
    BertTokenizer,
)
