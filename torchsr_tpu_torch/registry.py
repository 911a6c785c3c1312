"""Model registry: name -> generator class / trainer class / crop size.

Case-insensitive lookup with a ``RuntimeError`` on a miss, as in the
JAX package.  Only ESRGAN is ported so far.
"""

from __future__ import annotations

from argparse import Namespace


def _generators() -> dict:
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    return {"esrgan": ESRGANGenerator}


MODEL_NAMES = ("esrgan", "srgan")

# HR training crop per model (the reference registry's)
CROP_SIZE = {"esrgan": 128, "srgan": 96}


def _srgan_not_ported() -> RuntimeError:
    return RuntimeError(
        "SRGAN is not ported to the PyTorch package yet (ROADMAP A9); "
        "use --model esrgan, or the JAX package for SRGAN"
    )


def select_trainer_model(args: Namespace) -> tuple[type, int]:
    """Return (trainer class, crop size) for the requested model."""
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer

    name = args.model.lower()
    if name == "esrgan":
        return ESRGANTrainer, CROP_SIZE[name]
    if name == "srgan":
        raise _srgan_not_ported()
    raise RuntimeError(
        f"{args.model} not supported. Please choose from: ['esrgan']"
    )


def select_test_model(args: Namespace) -> type:
    """Return the generator class for the requested model."""
    name = args.model.lower()
    generators = _generators()
    if name in generators:
        return generators[name]
    if name == "srgan":
        raise _srgan_not_ported()
    raise RuntimeError(
        f"{args.model} not supported. Please choose from: "
        f"{list(generators.keys())}"
    )
