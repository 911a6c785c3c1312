"""Tensor operations: the kernel wrappers (RDB, pair synthesis, 3x3 conv)
and their plain versions, resizing.

Importing the package registers the RDB forward operator
(``torchsr_tpu_torch::rdb_fwd``, ``ops/rdb.py``), which a serving
artifact exported with native kernels calls: such an artifact loads with
this package and ``torch`` alone."""

from torchsr_tpu_torch.ops import rdb as rdb  # noqa: F401  (registers the op)
