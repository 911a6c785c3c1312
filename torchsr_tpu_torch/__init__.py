"""torchsr-tpu on PyTorch and CUDA: the ESRGAN serving path for Hopper.

A second package beside the JAX one (``torchsr_tpu``), which stays the
reference.  It imports ``torch``, numpy and the standard library only.
The residual dense block, the one TPU kernel on the serving path, runs
as a hand-written CUDA kernel (``ops/csrc/rdb_fwd.cu``); everything
else is plain PyTorch.

Layouts follow the JAX package at every public function: images and
activations are NHWC, conv kernels handed to ``fused_rdb`` are HWIO,
and the modules' ``state_dict`` uses the reference's key names.
Entry points run on the CUDA device unless the caller asks for the CPU.
"""

from torchsr_tpu_torch.__version__ import VERSION

__version__ = VERSION

__all__ = ["VERSION", "__version__"]
