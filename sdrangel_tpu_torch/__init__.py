"""sdrangel_tpu_torch — the Rx product path, the one-card channel-bank
gear, the Rx and Tx sessions, the REST server and the Tx path of
sdrangel_tpu in PyTorch.

The same layer map as the JAX package (`dsp/`, `channels/`, `runtime/`,
`io/`, `parallel/`, `__main__.py`) with the same module and function names,
plus `kernels/`: the hand-written CUDA kernels for Hopper (`kernels/csrc/`),
their builds and their Python wrappers (`kernels/decimator.py` holds the
Pallas decimators' counterparts under their JAX names). `parallel/sharded.py`
is the bank gear (÷2^k → PFB → batched demods) on one card. Tensors carry their device; every entry
point that creates state takes an explicit `torch.device`. The package never
imports jax, nor the JAX package: the few numpy helpers it shares with it
(half-band tables, FFT windows, the test source, WAV and .sdriq I/O, the
CW keyer, the block FIFO) are copied here and held equal to the originals by the tests.
"""

__version__ = "0.1.0"
