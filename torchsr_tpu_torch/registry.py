"""Model registry: name -> generator class / trainer class / crop size.

Case-insensitive lookup with a ``RuntimeError`` on a miss, as in the
JAX package.
"""

from __future__ import annotations

from argparse import Namespace


def _generators() -> dict:
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.models.hat import HATGenerator
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    return {"esrgan": ESRGANGenerator, "srgan": SRGANGenerator,
            "hat": HATGenerator}


def _trainers() -> dict:
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer

    return {"esrgan": ESRGANTrainer, "srgan": SRGANTrainer}


MODEL_NAMES = ("esrgan", "srgan", "hat")
# served and tested, not trained: the port has no HAT recipe
INFERENCE_ONLY = ("hat",)

# HR training crop per model (the reference registry's)
CROP_SIZE = {"esrgan": 128, "srgan": 96}


def _lookup(args: Namespace, table: dict):
    name = args.model.lower()
    if name not in table:
        raise RuntimeError(
            f"{args.model} not supported. Please choose from: "
            f"{list(table)}"
        )
    return name, table[name]


def select_trainer_model(args: Namespace) -> tuple[type, int]:
    """Return (trainer class, crop size) for the requested model."""
    if args.model.lower() in INFERENCE_ONLY:
        raise RuntimeError(
            f"{args.model} is served and tested only: the port has no "
            f"training recipe or discriminator for it. Train one of "
            f"{list(_trainers())}")
    name, trainer = _lookup(args, _trainers())
    return trainer, CROP_SIZE[name]


def select_test_model(args: Namespace) -> type:
    """Return the generator class for the requested model."""
    return _lookup(args, _generators())[1]
