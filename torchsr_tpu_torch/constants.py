"""Default configuration constants (own copy of the JAX package's; the
training defaults come with the training slice)."""

MODEL = "ESRGAN"

# Supported image extensions for directory discovery.
SUPPORTED_IMAGES = (".jpg", ".jpeg", ".png")
