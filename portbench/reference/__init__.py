"""The plain reference of the benchmark's cells: plain PyTorch and NumPy,
importing nothing of the program under test."""
