"""DSP blocks of the Rx and Tx paths as plain functions on tensors with carried
NamedTuple states (the JAX package's sdrangel_tpu.dsp, same names)."""
