"""Hand-written CUDA kernels for Hopper, their build and their wrappers.

Each wrapper launches its kernel on a CUDA tensor, runs its plain PyTorch
twin on a CPU tensor, and counts its launches in a plain integer attribute.
"""
