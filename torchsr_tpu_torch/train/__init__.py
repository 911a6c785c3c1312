"""Two-phase ESRGAN training: losses, metrics, optimizers, trainer."""
