"""Host-side I/O: the synthetic test source, WAV egress and .sdriq capture
reading. Plain numpy; copies of the JAX package's io modules."""
