from easynlp_tpu_torch.modelzoo.models.artist.modeling_artist import (  # noqa: F401
    ARTISTConfig,
    ARTISTModel,
    VectorQuantizer,
    VQGANDecoder,
    VQGANEncoder,
)
