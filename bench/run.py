"""Run one cell of the benchmark once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for. Prints one JSON result line last on standard output."""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
