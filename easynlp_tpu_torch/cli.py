"""CLI entry for the PyTorch port (counterpart of easynlp_tpu/cli.py,
without the user-script launcher). Usage:

    python -m easynlp_tpu_torch.cli --mode=predict --app_name=text_classify \
        --tables=dev.tsv --outputs=pred.tsv --input_schema=... \
        --first_sequence=... --output_schema=predictions,probabilities \
        --checkpoint_dir=./model --device=cuda
"""

import sys

from easynlp_tpu_torch.appzoo.api import default_main_fn
from easynlp_tpu_torch.utils.initializer import initialize_easynlp


def main(argv=None):
    args = initialize_easynlp(args_list=argv)
    default_main_fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
