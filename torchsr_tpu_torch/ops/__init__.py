"""Tensor operations: the RDB kernel wrapper and its plain version, resizing."""
