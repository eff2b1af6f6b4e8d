"""The JAX package's parallel/ on one card: `sharded.py`, the channel-bank
gear (÷2^k → PFB → batched demods). Several cards over torch.distributed
wait in ROADMAP.md's `parallel/` queue."""
