"""The JAX package's parallel/: the (time × channel) device mesh and its
collectives (`mesh.py`, within a process or across processes over
torch.distributed), the channel-bank gears on it (`sharded.py`), the
host feed of their time shards (`hostfeed.py`) and the entry point of one
process of a mesh that spans processes (`worker.py`)."""
