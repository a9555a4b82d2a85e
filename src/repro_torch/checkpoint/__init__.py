"""npz + json checkpoints of tensor trees (``checkpoint.py``)."""
