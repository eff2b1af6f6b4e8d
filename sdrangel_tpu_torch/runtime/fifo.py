"""Bounded sample-block FIFOs — the SampleSourceFifo/SampleSinkFifo roles.

Reference: sdrbase/dsp/samplesourcefifo.{h,cpp} (Tx: channel sources fill,
the device sink drains at DAC pace) and samplesinkfifo.{h,cpp} (Rx mirror).
The reference FIFOs are sample-granular ring buffers with read/write
pointers under a mutex; the block-parallel translation is a bounded deque
of whole device blocks: the producer blocks (backpressure) when the
consumer falls behind, exactly the reference's write-side behaviour when
the ring is full (samplesourcefifo.cpp write() waits on readSync).

Used by the session's Tx worker: the device-step producer thread pushes
int16 device blocks; a writer thread drains them to the .sdriq sink — so
device compute, host serialization, and disk IO pipeline instead of
running lockstep. The port's own copy of the JAX package's
sdrangel_tpu/runtime/fifo.py.
"""

from __future__ import annotations

import collections
import threading


class BlockFifo:
    """Bounded FIFO of whole sample blocks with blocking put/get.

    put() blocks when `depth` blocks are queued (producer backpressure);
    get() blocks until a block arrives or the FIFO is closed. close()
    wakes both sides; a closed FIFO drains remaining blocks then returns
    None from get().
    """

    def __init__(self, depth: int = 8):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = depth
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        #: write-side stalls — the reference's FIFO-full signal
        self.backpressure_waits = 0
        self.blocks_in = 0
        self.blocks_out = 0

    def put(self, block, timeout: float | None = None) -> bool:
        """Queue one block; blocks while full. False if closed (or timeout)."""
        with self._not_full:
            if len(self._q) >= self.depth and not self._closed:
                self.backpressure_waits += 1
            while len(self._q) >= self.depth and not self._closed:
                if not self._not_full.wait(timeout):
                    return False
            if self._closed:
                return False
            self._q.append(block)
            self.blocks_in += 1
            self._not_empty.notify()
            return True

    def get(self, timeout: float | None = None):
        """Dequeue one block; blocks while empty. None when closed+drained."""
        with self._not_empty:
            while not self._q and not self._closed:
                if not self._not_empty.wait(timeout):
                    return None
            if not self._q:
                return None  # closed and drained
            block = self._q.popleft()
            self.blocks_out += 1
            self._not_full.notify()
            return block

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    @property
    def fill(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
