"""Run one cell of the benchmark once:

    python3 vrbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are named in ``BENCHMARK.json``. The last line of standard output is the
result as one JSON object; the numbers compared for ``correct`` end
standard error. Exits 2 without the CUDA devices the cell asks for, 3 if
JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vrbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
