"""The plain reference of the benchmark's cells: float32 PyTorch, TF32 off,
written from the published method and independent of the measured program
(it imports nothing of it, nor of its JAX twin)."""
