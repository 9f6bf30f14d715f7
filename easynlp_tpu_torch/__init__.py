"""EasyNLP PyTorch port: the EasyNLP-TPU toolkit on PyTorch and CUDA.

A second package beside `easynlp_tpu` (the JAX reference). It mirrors that
package's paths and names and imports nothing of it: what both need (flags,
configs, tokenizers, TSV reading) the port keeps in its own copy. Ported so far:
train/evaluate/predict of the BERT apps (text_classify, text_match,
sequence_labeling, machine_reading_comprehension; vectorization predict),
`--mode=predict --app_name=sequence_generation` on GPT-2, BART
train/evaluate/predict, and `--mode=serve` (the pipeline() server, and
continuous-batching GPT-2 generation behind /generate), with hand-written
CUDA kernels for attention, the ports of all five TPU kernels (see
ROADMAP.md for what comes next).
"""

__version__ = "0.1.0"

from easynlp_tpu_torch.utils.initializer import initialize_easynlp  # noqa: F401,E402
