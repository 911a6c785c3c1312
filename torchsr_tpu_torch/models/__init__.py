"""Networks of the PyTorch/CUDA port (NHWC, reference state_dict keys)."""

from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

__all__ = ["ESRGANGenerator"]
