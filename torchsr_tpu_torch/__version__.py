"""Version of the PyTorch/CUDA package, kept in step with the JAX one."""

MAJOR = 0
MINOR = 1
PATCH = 0

VERSION = f"{MAJOR}.{MINOR}.{PATCH}"
