"""FacialMMT on PyTorch and CUDA: the T+A+V serving and multi-task training
paths of `facialmmt_tpu`, ported module for module, with hand-written Hopper
(sm_90a) kernels in place of the JAX package's Pallas kernels.

The JAX package stays the reference; this package imports nothing of it and
nothing of JAX.  Module paths mirror the JAX package (``ops/swin.py`` here is
``facialmmt_tpu/ops/swin.py`` there).
"""

__version__ = "0.2.0"

from facialmmt_tpu_torch.config import FacialMMTConfig  # noqa: F401
