"""deeppicarditeration_torch — the PyTorch/CUDA port of deeppicarditeration_tpu.

The JAX package beside this one is the reference; every module here keeps
the path and names of its JAX counterpart. The port imports ``torch`` and
nothing of JAX. Its one Monte-Carlo estimator kernel is hand-written CUDA
for Hopper (``csrc/generate.cu``, built at first use into
``build/kernels/``); everything else is plain PyTorch.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(or the config key ``DEVICE: cpu``); without a card and without that
request they raise.
"""

__version__ = "0.1.0"

from deeppicarditeration_torch.config import Config, default_cfg, load_cfg
from deeppicarditeration_torch.device import resolve_device

__all__ = ["Config", "default_cfg", "load_cfg", "resolve_device",
           "__version__"]
