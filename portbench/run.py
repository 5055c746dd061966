"""The benchmark of the PyTorch and CUDA port (`contexture_nerf_tpu_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell on the card this process is started on: it makes the cell's
weights and inputs from the seed on the device, builds the program's path,
warms it up (set-up), measures for --seconds (--trace 0: the cell's
end-to-end metrics) or traces a short window (--trace 1: its per-layer
metrics, from torch.profiler), then frees the program and holds what the
timed path produced to the plain f32 reference under portbench/reference/.
The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key. Without a card it exits 2 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, torch, device="cuda", tiny=False, fault=None, control=False,
        out=print, err=None, cell=None):
    """One run of a cell. `tiny`, `fault`, `control` and the CPU device serve
    the benchmark's own tests, which drive a run without the look for a
    card."""
    err = err or (lambda line: print(line, file=sys.stderr, flush=True))
    cell = cell or harness.Cell(args.workload)
    driver = cell.driver()
    state = driver.setup(cell, args.seed, torch, device=device, tiny=tiny,
                         fault=fault, control=control)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START if not tiny else 0.0
    err("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 getattr(state, "phases", {}).items())
        + f"; total {setup_s:.3f}")
    metrics, breakdown, dev_extra = {}, None, {}
    if args.trace:
        from portbench import tracekit

        trace = driver.traced_window(state, torch)
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tracekit.breakdown(trace)
        dev_extra = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        err(f"traced step ms {trace.ms_per_unit()!r}; untraced "
            f"{trace.untraced_ms!r}; kernels in window {len(trace.kernels)}")
    else:
        e2e = driver.window(state, torch, args.seconds)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end():
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    attempted, failed = driver.counts(state, torch)
    peak = driver.peak_bytes(state, torch)
    check = driver.check(state, torch)
    found = harness.forbidden_modules()
    if found:
        err(f"the process holds JAX or the JAX package: {found}")
        return 3
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in check.values()) and failed == 0
    dev = (harness.device_record(torch, peak, cell.spec["chips"], **dev_extra)
           if device != "cpu" else {"platform": "cpu", "kind": "cpu",
                                    "count": 1, "memory_peak_bytes": 0})
    for line in harness.check_lines(check):
        err(line)
    out(harness.result_line(correct, attempted, failed, metrics, dev, check,
                            breakdown))
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    harness.apply_env(harness.cache_env())
    import torch

    why = None
    try:
        cell = harness.Cell(args.workload)
        why = harness.require_cards(torch, int(cell.spec["chips"]))
    except FileNotFoundError as e:
        why = f"no such cell or file: {e}"
    if why:
        print(why, file=sys.stderr, flush=True)
        return 2
    torch.set_num_threads(4)
    rc = run(args, torch, cell=cell)
    gc.collect()
    return rc


if __name__ == "__main__":
    sys.exit(main())
