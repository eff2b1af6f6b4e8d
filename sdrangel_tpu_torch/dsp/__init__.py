"""DSP blocks of the Rx path as plain functions on tensors with carried
NamedTuple states (the JAX package's sdrangel_tpu.dsp, same names)."""
