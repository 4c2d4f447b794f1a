"""The plain reference: ``svo/`` (a frozen copy of the port's eager code
with plain kernels) and ``runner.py``, which steps it from a state."""
