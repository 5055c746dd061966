"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the numbers the run compares, of the
program as the configuration states it (`--mode program`), of the
configuration's lower-precision control (`--mode control`: the program
with its own int8 teacher path switched on), or of a planted fault
(`--mode unchanged|half_batch|altered`). One process reads every seed;
the benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload sds_default --mode control \
        --seeds 11 12 13

Prints one JSON line a seed: {"seed", "mode", "check": {name: value}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

MODES = ("program", "control", "unchanged", "half_batch", "altered")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=MODES, default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    harness.apply_env(harness.cache_env())
    import torch

    cell = harness.Cell(args.workload)
    why = harness.require_cards(torch, int(cell.spec["chips"]))
    if why:
        print(why, file=sys.stderr)
        return 2
    driver = cell.driver()
    fault = args.mode if args.mode not in ("program", "control") else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = driver.setup(cell, seed, torch, fault=fault,
                             control=args.mode == "control")
        driver.window(state, torch, 0.0)  # one step or job at the cell's load
        check = driver.check(state, torch)
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "check": {k: v["value"] for k, v in check.items()},
                          "diagnostics": getattr(state, "diagnostics", {}),
                          "s": time.perf_counter() - t0}), flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
