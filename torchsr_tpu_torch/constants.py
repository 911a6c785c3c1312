"""Default configuration constants (the port's own copy of the JAX
package's ``torchsr_tpu/constants.py``)."""

BATCH_SIZE = 64
EPOCHS = 1000
PRE_EPOCHS = 1000

TRAIN_DIR = "dataset"

MODEL = "ESRGAN"

# Supported image extensions for directory discovery.
SUPPORTED_IMAGES = (".jpg", ".jpeg", ".png")
