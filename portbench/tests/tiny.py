"""Tiny versions of the benchmark's cells for the CPU tests: the same
files and code, at a lower rate and a shorter block."""

from __future__ import annotations

import math

from portbench import harness

#: the cells
CELLS = ["product-nfm16", "bank64-stream"]


def cell(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    if c.config["driver"] == "rxpipeline":
        # the cell's 625 kHz baseband from a 1.25 MS/s capture ÷2: four of its
        # channels, the noise as strong in each as the cell's
        rate = 1250000
        c.traffic["noise_dbfs"] += 10 * math.log10(rate / c.config["sample_rate"])
        c.config.update(sample_rate=rate, log2_decim=1, device_block=320000)
        c.traffic["channels_hz"] = c.traffic["channels_hz"][6:10]
        c.traffic["carriers"]["count"] = 2
    else:
        # the cell's 48 kHz grid and ÷2 from a 768 kS/s capture: PFB-8, the
        # demods of slots -2..1, the noise as strong in each slot as the cell's
        rate = 768000
        slots = [o for o in c.config["offsets_hz"] if -2 <= round(o / 48000) <= 1]
        c.config.update(sample_rate=rate, block=1 << 17, pfb_m=8, offsets_hz=slots)
        c.config["bank"]["count"] = len(slots)
        c.traffic["carriers"].update(count=3, levels_dbfs=[-15.0, -30.0, -45.0])
        c.traffic["noise_dbfs"] += 10 * math.log10(rate / 12288000)
    c.traffic.update(ring_blocks=3, warm_blocks=2, compare_blocks=2, profile_blocks=2)
    return c
