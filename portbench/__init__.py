"""The benchmark of the PyTorch port (manisdp_tpu_torch): one command,
``python3 portbench/run.py``, and the data and code it finds by name
(portbench/README.md)."""
