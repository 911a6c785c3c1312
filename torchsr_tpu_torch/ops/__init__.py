"""Tensor operations: the kernel wrappers (RDB, pair synthesis, 3x3 conv)
and their plain versions, resizing."""
