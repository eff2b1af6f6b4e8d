"""The control of the comparison: the plain reference put in the
program's place and computed in TF32 (float32 with every filter
product's operands rounded to 10 mantissa bits) — the precision below
the float32-with-TF32-off that the configurations state. `correct` has
to come out false for it.

    python3 -m portbench.control --workload <cell> --seeds <n> ... [--seconds <s>]

reads, in one process on the card, the compared numbers of sound runs of
the program and of the control on each seed, and prints each number's
largest reading over the program's runs (the lower reading of its limit)
and smallest over the control's (the upper reading), as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from . import harness
from .reference import dsp


def in_place_of_program(system) -> None:
    """Make `system`'s loop yield the reference's outputs in TF32 for each
    block, worked out from that block and the one before it."""
    drv, cfg, tr, ring = system.driver, system.config, system.traffic, system.ring
    device = system.device

    def loop(hooks):
        b = 0
        while True:
            hooks.feed(b)
            raws = [torch.as_tensor(ring[i % len(ring)]).to(device)
                    for i in ((b - 1, b) if b else (0,))]
            yield b, drv.reference(cfg, tr, raws, dsp.TF32)
            b += 1

    system.loop = loop


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--detail", action="store_true",
                   help="print each compared block's error by channel and where it lies")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = []
    for kind, seeds, patch in (("program", args.seeds, None),
                               ("control", args.control_seeds, in_place_of_program)):
        for seed in seeds:
            out = harness.run_cell(cell, seed, args.seconds, bool(args.trace), "cuda",
                                   patch=patch, inspect=detail if args.detail else None)
            numbers = out.numbers
            rows.append({"kind": kind, "seed": seed, "correct": out.correct,
                         "blocks": out.attempted, "numbers": numbers})
            print(json.dumps(rows[-1]), flush=True)
    names = list(rows[0]["numbers"])
    for name in names:
        prog = [r["numbers"][name] for r in rows if r["kind"] == "program"]
        ctl = [r["numbers"][name] for r in rows if r["kind"] == "control"]
        print(json.dumps({"number": name, "lower": max(prog, key=_key),
                          "upper": min(ctl, key=_key), "limit": cell.limits.get(name)}),
              flush=True)
    return 0


def _audio_rows(outputs):
    if isinstance(outputs, dict):
        return [np.asarray(c["audio"], np.float64) for c in outputs["channels"]]
    return list(np.asarray(outputs, np.float64))


def detail(b, ours, ref) -> None:
    """Each channel's relative audio error in block b, and for the worst,
    where its largest sample error lies, the share of the error's energy
    within 400 samples of it, and the reference's audio RMS."""
    errs = []
    for o, r in zip(_audio_rows(ours), _audio_rows(ref)):
        d = o - r
        k = int(np.argmax(np.abs(d)))
        near = float(np.sum(d[max(0, k - 400):k + 400] ** 2) / max(np.sum(d ** 2), 1e-300))
        errs.append((float(np.linalg.norm(d) / np.linalg.norm(r)), k, near,
                     float(np.sqrt(np.mean(r ** 2)))))
    worst = max(range(len(errs)), key=lambda i: errs[i][0])
    print(json.dumps({"block": b, "rel_err": [e[0] for e in errs], "worst": worst,
                      "at": errs[worst][1], "energy_near": errs[worst][2],
                      "ref_rms": errs[worst][3]}), flush=True)


def _key(v) -> float:
    return math.inf if v is None or (isinstance(v, float) and math.isnan(v)) else v


if __name__ == "__main__":
    sys.exit(main())
