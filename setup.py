"""Package setup (capability parity: reference setup.py — the `easynlp`
console entry point, setup.py:21)."""

import os

from setuptools import find_packages, setup

setup(
    name="easynlp-tpu",
    version="0.1.0",
    description="TPU-native NLP & multi-modal toolkit (JAX/XLA/Pallas/pjit) "
                "with the capabilities of EasyNLP",
    packages=find_packages(include=["easynlp_tpu", "easynlp_tpu.*",
                                    "easynlp_tpu_torch", "easynlp_tpu_torch.*"]),
    package_data={"easynlp_tpu": ["native_lib/*.so"],
                  "easynlp_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy",
    ],
    extras_require={
        "test": ["pytest", "torch", "transformers", "scikit-learn"],
        "images": ["Pillow"],
    },
    entry_points={
        "console_scripts": [
            "easynlp=easynlp_tpu.cli:main",
            "easynlp-torch=easynlp_tpu_torch.cli:main",
        ],
    },
)
