"""Data parallelism of the port: the device mesh (``mesh.py``) and the
process groups of multi-device and multi-host training (``distributed.py``)."""
