"""Tensor operations: the kernel wrappers (RDB, pair synthesis, 3x3 conv,
BatchNorm with its PReLU or skip add, HAT's window attentions) and their
plain versions, resizing.

Importing the package registers the RDB forward operator
(``torchsr_tpu_torch::rdb_fwd``, ``ops/rdb.py``), which a serving
artifact exported with native kernels calls: such an artifact loads with
this package and ``torch`` alone."""

from torchsr_tpu_torch.ops import bn_act as bn_act
from torchsr_tpu_torch.ops import rdb as rdb  # (registers the op)
from torchsr_tpu_torch.ops import window_attn as window_attn

# The kernels on the generators' paths, whose launch counters (each
# module's ``LAUNCH_COUNTERS``) advance in Python: ``train/graphs.py``
# adds a captured graph's share once per replay, and the tools report
# them.  ``ops.rdb.plain_forward()`` takes the RDB and BatchNorm kernels
# off; HAT's attention kernel (``window_attn``) has no such switch: its
# plain version runs on CPU tensors only.
MODEL_KERNELS = (rdb, bn_act, window_attn)


def launch_counts() -> dict:
    """The model kernels' launch counters, by name."""
    return {name: getattr(module, name)
            for module in MODEL_KERNELS for name in module.LAUNCH_COUNTERS}


def counter_help() -> dict:
    """Each model kernel counter's line of help, by name."""
    return {name: text for module in MODEL_KERNELS
            for name, text in module.COUNTER_HELP.items()}


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (counter name -> launches) to the
    counters."""
    for module in MODEL_KERNELS:
        for name in module.LAUNCH_COUNTERS:
            if name in delta:
                setattr(module, name,
                        getattr(module, name) + delta[name] * times)
