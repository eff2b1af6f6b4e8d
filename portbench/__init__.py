"""The benchmark of the PyTorch/CUDA port (`sdrangel_tpu_torch`) on one
CUDA card: configurations, traffic, the harness, the plain reference and
the per-layer metric readers. See README.md."""
