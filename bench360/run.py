"""Run one cell of BENCHMARK.json once, on the machine it starts on.

    python3 bench360/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(correct, attempted, failed, metrics, device, and with --trace 1 the
breakdown), and the numbers the correctness check compared, each with its
limit, as the last lines on standard error. Exits non-zero, with no
result, without the CUDA devices the cell asks for. See README.md.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench360.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(t_process=T_PROCESS))
