"""Networks of the PyTorch/CUDA port (NHWC, reference state_dict keys)."""

from torchsr_tpu_torch.models.esrgan import (
    ESRGANDiscriminator,
    ESRGANGenerator,
)
from torchsr_tpu_torch.models.srgan import (
    SRGANDiscriminator,
    SRGANGenerator,
)
from torchsr_tpu_torch.models.vgg import VGG19Features

__all__ = ["ESRGANDiscriminator", "ESRGANGenerator", "SRGANDiscriminator",
           "SRGANGenerator", "VGG19Features"]
