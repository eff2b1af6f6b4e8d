"""sdrangel_tpu_torch — the Rx product path of sdrangel_tpu in PyTorch.

The same layer map as the JAX package (`dsp/`, `channels/`, `runtime/`,
`io/`, `__main__.py`) with the same module and function names, plus
`kernels/`: the hand-written CUDA kernels for Hopper (`kernels/csrc/`), their
builds and their Python wrappers. Tensors carry their device; every entry
point that creates state takes an explicit `torch.device`. The package never
imports jax, nor the JAX package: the few numpy helpers it shares with it
(half-band tables, FFT windows, the test source, WAV and .sdriq I/O) are
copied here and held equal to the originals by the tests.
"""
