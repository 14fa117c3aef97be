"""debiasing_multi_modal_tpu_torch — the PyTorch/CUDA port of
``debiasing_multi_modal_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package mirrors its
subpackage and module names so each counterpart is easy to find, and imports
nothing of it (nor ``jax``).  Every Pallas kernel on a ported path becomes a
hand-written CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda_build.py``); each has a plain PyTorch version in the same module,
which the wrapper takes only for tensors on the CPU.

Ported so far: Stage A extraction with the ResNet and ViT CLIP towers
(``models/``, ``ops/``, ``weights/convert.py``, ``extract/``,
``cli/extract_main.py``), with ``fuse_qkv`` and the int8 ``quant`` modes;
Stage B adapter training (``models/adapter.py``, ``train/``,
``cli/train_main.py``) for every method but ``contrastive_adapter``.
Public entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Importing the package loads no kernel library and imports no Triton.
"""

__version__ = "0.1.0"
