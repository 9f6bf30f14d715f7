"""HTTP model serving for the PyTorch port (counterpart of
easynlp_tpu/serving): a dependency-free HTTP server over pipeline() with
dynamic micro-batching (PredictionServer, serve), and continuous-batching
GPT-2 generation (ContinuousBatcher, DeviceContinuousDecoder) behind POST
/generate (GenerationServer)."""

from easynlp_tpu_torch.serving.continuous import (  # noqa: F401
    ContinuousBatcher,
    DeviceContinuousDecoder,
)
from easynlp_tpu_torch.serving.server import (  # noqa: F401
    GenerationServer,
    PredictionServer,
    serve,
)
