"""Multi-process data parallelism and the device lists of sharded
inference (``mesh.py``)."""
