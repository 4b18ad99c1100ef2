"""The benchmark's one command:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up line and then, as its last line, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and ``checks``; each number the check
compared is also printed beside its limit as the last lines of standard
error."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark.bm import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
