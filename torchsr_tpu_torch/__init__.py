"""torchsr-tpu on PyTorch and CUDA: ESRGAN and SRGAN for Hopper.

A second package beside the JAX one (``torchsr_tpu``), which stays the
reference.  It imports ``torch``, numpy and the standard library only
(Pillow and msgpack where an image or a JAX checkpoint is read).
Every TPU kernel of the JAX package runs as a hand-written CUDA kernel
(``ops/csrc/``): the residual dense block's forward and backward on
ESRGAN's paths, the rest on the bench tools'; everything else, the
SRGAN networks included, is plain PyTorch.

Layouts follow the JAX package at every public function: images and
activations are NHWC, conv kernels handed to ``fused_rdb`` are HWIO,
and the modules' ``state_dict`` uses the reference's key names.
Entry points run on the CUDA device unless the caller asks for the CPU.
"""

from torchsr_tpu_torch.__version__ import VERSION

__version__ = VERSION

__all__ = ["VERSION", "__version__"]
