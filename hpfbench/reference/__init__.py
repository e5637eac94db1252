"""The plain references that decide ``correct``: PyTorch and NumPy only,
nothing of ``hpfrec_tpu_torch``, ``hpfrec_tpu`` or JAX."""
