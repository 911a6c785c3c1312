"""The benchmark of ``torchsr_tpu_torch`` on NVIDIA cards.

One command runs one cell once::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is data found by name: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``),
the cell (``workloads/<cell>.json``: its configuration, traffic, driver,
chips and the limits of its correctness check), the driver of its kind
(``drivers/<kind>.py``), the kernel families its traced slices count
(``kernels/<family>.json``) and one reader a per-layer metric
(``metrics/<metric>.py``).  The yardstick lives here too: the plain f32
reference (``reference/``, which imports nothing of the port), the traffic
generator (``generate.py``), the FLOP and byte arithmetic
(``flops.py``), the seeded weights (``weights.py``), the trace
reduction (``trace.py``) and the comparisons that decide ``correct``
(``compare.py``).  ``control.py`` reads the control and the faults that
set the upper ends of the checks' limits; ``tests/`` holds all of it on
the CPU.  Nothing here imports JAX or the JAX
package ``torchsr_tpu``.
"""
