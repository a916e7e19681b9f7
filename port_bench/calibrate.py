"""Readings that set the limits of ``correct``: the numbers a cell compares,
over many seeds in one process.  The benchmark's own runs do not run this.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 --mode sound

Each seed builds the cell's driver in ``--mode`` as a run builds it, runs
the units whose outputs a run compares (the driver's ``check_units``: a
prune, one piece of each of the round's lane pieces; a trainer, its steps
up to the first retraction), releases it and prints one JSON line with the
compared numbers.  The modes are the driver's own (its ``MODES``):
``sound``, the program as the configuration states it; ``control``, the
nearest precision below the configuration's; a fault's name, that fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import guard, spec


def readings(cell: spec.Cell, seed: int, mode: str, device) -> list:
    """The compared numbers ``[(name, value, limit)]`` of one seed."""
    drv = spec.load_driver(cell.config["driver"]).Driver(cell.config, cell.traffic, seed,
                                                         device, mode=mode)
    drv.setup()
    for _ in range(drv.check_units):
        drv.unit()
    drv.release()
    return drv.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--mode", default="sound", help="one of the driver's MODES")
    args = p.parse_args(argv)
    guard.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    modes = spec.load_driver(cell.config["driver"]).MODES
    if args.mode not in modes:
        print(f"port_bench.calibrate: {args.workload} has the modes {modes}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = readings(cell, seed, args.mode, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "mode": args.mode,
                          "seconds": time.perf_counter() - t0,
                          "checks": {name: value for name, value, _ in checks}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
