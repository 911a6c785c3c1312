"""Model registry: name -> generator class.

Case-insensitive lookup with a ``RuntimeError`` on a miss, as in the
JAX package.  Only ESRGAN is ported so far.
"""

from __future__ import annotations

from argparse import Namespace


def _generators() -> dict:
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    return {"esrgan": ESRGANGenerator}


MODEL_NAMES = ("esrgan", "srgan")


def select_test_model(args: Namespace) -> type:
    """Return the generator class for the requested model."""
    name = args.model.lower()
    generators = _generators()
    if name in generators:
        return generators[name]
    if name == "srgan":
        raise RuntimeError(
            "SRGAN is not ported to the PyTorch package yet (ROADMAP "
            "A9); use --model esrgan, or the JAX package for SRGAN"
        )
    raise RuntimeError(
        f"{args.model} not supported. Please choose from: "
        f"{list(generators.keys())}"
    )
