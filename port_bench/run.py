"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for; without them it exits with code 2 and prints no result.  The run:

1. set-up, timed from the process's start (``setup_s``): the driver named
   by the cell's configuration builds the program, makes the inputs and
   weights on the card from ``--seed`` and warms up every shape;
2. the window: the driver's units back to back, each started only while
   less than ``--seconds`` has passed (``--trace 1``: under torch.profiler,
   card activity only);
3. the peak device memory is read, and the process is checked to hold no
   JAX module;
4. the program's state is freed and the plain reference checks what the
   timed path produced; each number compared is printed beside its limit,
   last on standard error and under ``checks``, last in the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import guard, spec  # noqa: E402
from .compare import as_json, verdict  # noqa: E402

EXIT_NO_CARD = 2
EXIT_JAX = 3
EXIT_NO_DEVICE_EVENTS = 4


class RunError(RuntimeError):
    """A run that must print no result."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def power_limit() -> str:
    """``name, power.limit`` of the card from ``nvidia-smi`` ('' without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """One run of ``cell`` on ``device``: ``(result object, [(name, value,
    limit)] compared)``.  Raises ``RunError`` where a run must print no
    result."""
    import torch

    from .trace import traced

    drv = spec.load_driver(cell.config["driver"]).Driver(cell.config, cell.traffic, seed, device)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ends = []
    box: list = []

    def window():
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        while time.perf_counter() - t0 < seconds:
            drv.unit()
            ends.append(time.perf_counter())
        return t0, setup_s

    if trace:
        with traced(device) as box:
            t0, setup_s = window()
    else:
        t0, setup_s = window()
    if not ends:
        raise RunError("the window ran no unit of work", EXIT_NO_DEVICE_EVENTS)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    found = guard.forbidden_modules()
    if found:
        raise RunError(f"the process holds {found} once the window has closed", EXIT_JAX)
    units = SimpleNamespace(t0=t0, ends=ends, window_s=ends[-1] - t0)
    counters = drv.counters()
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result = {"correct": False, "attempted": drv.attempted, "failed": drv.failed}
    if trace:
        tr = box[0]
        if tr.launches == 0:
            raise RunError("the traced window holds no device operation", EXIT_NO_DEVICE_EVENTS)
        # what a reader may take; a later reader adds a file and edits nothing here
        ctx = SimpleNamespace(trace=tr, counters=counters, config=cell.config,
                              traffic=cell.traffic, units=units, peak_bytes=peak)
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        values = {**drv.end_to_end(t0, ends), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info["power_limit"] = power_limit() if device.type == "cuda" else ""
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    result.update(correct=verdict(checks), metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = as_json(checks)  # last: the numbers compared, beside their limits
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    guard.pin_caches()
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    torch.set_num_threads(1)
    try:
        result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T_START)
    except RunError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return e.code
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
