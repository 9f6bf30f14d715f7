from easynlp_tpu_torch.modelzoo.models.bert.configuration_bert import (  # noqa: F401
    BertConfig,
    RobertaConfig,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (  # noqa: F401
    BertForMaskedLM,
    BertModel,
)
from easynlp_tpu_torch.modelzoo.models.bert.tokenization_bert import (  # noqa: F401
    BertTokenizer,
)
from easynlp_tpu_torch.modelzoo.models.bert.tokenization_roberta import (  # noqa: F401
    RobertaTokenizer,
)
