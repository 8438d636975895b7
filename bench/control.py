"""The control of a cell's ``correct``: the reference put in the port's
place and computed in the next precision below the configuration's
(activations and gradients in float8 e4m3 with a per-tensor scale, for
the configurations' bfloat16), read beside the port's own numbers on the
same seeds, in one process, at the cell's own size:

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

Prints one JSON line a seed: the port's readings and the control's.
The benchmark's runs never run it; the limits in ``cells/<cell>.json``
were set from its readings (PERF.md)."""
import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    entry, cell, config = harness.cell_files(args.workload)
    harness.cache_env(harness.ROOT)
    device = harness.card_or_exit(int(entry["chips"]))
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.Run(args.workload, entry, cell, config, seed,
                          args.seconds, False, device)
        run.control = True
        out = harness.execute(run)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": {k: v["value"] for k, v in
                                      out["checks"].items()},
                          "control": getattr(run, "control_reading", None),
                          "metrics": out["metrics"]}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
