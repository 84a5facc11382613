"""Parallelism of the port: the device mesh (``mesh.py``), the process
groups of multi-device and multi-host training (``distributed.py``) and one
frame's rows split over the mesh (``spatial.py``)."""
