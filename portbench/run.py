"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

(or `python3 -m portbench.run ...` from the checkout's root). See
harness.py for what a run does and README.md for how cells are added.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run could write stays at a fixed place in the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(_ROOT, ".portbench_cache", _sub))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    origin = (harness.process_age_s(), time.perf_counter())
    sys.exit(harness.main(sys.argv[1:], origin))
