"""EasyNLP PyTorch port: the EasyNLP-TPU toolkit on PyTorch and CUDA.

A second package beside `easynlp_tpu` (the JAX reference). It mirrors that
package's paths and names and imports nothing of it: what both need (flags,
configs, tokenizers, TSV reading) the port keeps in its own copy. Ported so far:
`--mode=train|evaluate|predict --app_name=text_classify` on BERT and
`--mode=predict --app_name=sequence_generation` on GPT-2, with hand-written
CUDA kernels for attention (the short forward and backward, the flash
forward; see ROADMAP.md for what comes next).
"""

__version__ = "0.1.0"

from easynlp_tpu_torch.utils.initializer import initialize_easynlp  # noqa: F401,E402
