"""Benchmark driver: run stages, write JSON, print a verdict table.

Counterpart of ``tneq_tpu/bench/run_all.py`` (analogue of
``tools/run_all_fugaku_tests.sh``: stage selection + JSON summary)::

    python -m tneq_tpu_torch.bench.run_all --stages 1,2 --out results --device cuda

Each stage runs under a per-stage alarm, writes ``<stage>.json`` into
``--out`` and its row into ``summary.json`` (a subset run merges into an
existing summary).  ``--isolate`` runs each stage in a fresh process of
this module (``subprocess.run`` with a timeout), so one failing stage
cannot take the others' process state with it.  The reference package's
channel lock registration is its TPU tooling and has no counterpart here.
"""

from __future__ import annotations

import argparse
import functools
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

from .microbench import ALL_STAGES


class StageTimeout(Exception):
    pass


def _run_stage(name, fn, timeout_s: int):
    def handler(signum, frame):
        raise StageTimeout(name)

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(timeout_s)
    t0 = time.time()
    try:
        rec = fn()
        rec["wall_time_s"] = round(time.time() - t0, 2)
        # respect an explicit verdict from the stage
        rec["ok"] = rec.get("ok", True)
        # the suite stage id is authoritative over a stage fn's own key
        rec["stage"] = name
        return rec
    except StageTimeout:
        return {"stage": name, "ok": False, "error": f"timeout after {timeout_s}s"}
    except Exception as e:
        return {"stage": name, "ok": False, "error": f"{type(e).__name__}: {e}"}
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _run_isolated(selected, out_dir: Path, timeout_s: int, device: str) -> int:
    """One fresh process per stage; each child does a subset run that
    merges its row into summary.json.  A child that outlives its stage's
    alarm by a minute is killed and its failure recorded here."""
    for name in selected:
        print(f"=== {name} (isolated) ===", flush=True)
        try:
            r = subprocess.run(
                [sys.executable, "-m", "tneq_tpu_torch.bench.run_all",
                 "--stages", name, "--out", str(out_dir),
                 "--timeout", str(timeout_s), "--device", device],
                capture_output=True, text=True, timeout=timeout_s + 60,
            )
        except subprocess.TimeoutExpired:
            rec = {"stage": name, "ok": False,
                   "error": f"isolated child killed after {timeout_s + 60}s"}
            (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
            _merge_summary_row(out_dir, {"stage": name, "ok": False})
            print("  FAILED: child killed", flush=True)
            continue
        tail = (r.stdout or "").strip().splitlines()
        print(f"  child rc={r.returncode}"
              + (f": {tail[-2]}" if len(tail) >= 2 else ""), flush=True)
    try:
        summary = json.loads((out_dir / "summary.json").read_text())
    except (OSError, ValueError):
        summary = []
    rows = {s.get("stage"): s for s in summary}
    n_ok = sum(1 for n in selected if rows.get(n, {}).get("ok"))
    print(f"{n_ok}/{len(selected)} stages ok; results in {out_dir}/")
    return 0 if n_ok == len(selected) else 2


def _merge_summary_row(out_dir: Path, row: dict) -> None:
    """Insert/update one stage row in summary.json (ALL_STAGES order)."""
    path = out_dir / "summary.json"
    try:
        prior = {s["stage"]: s for s in json.loads(path.read_text())}
    except (OSError, ValueError, KeyError, TypeError):
        prior = {}
    prior[row["stage"]] = row
    path.write_text(json.dumps(
        [prior[k] for k in ALL_STAGES if k in prior], indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(description="tneq_tpu_torch benchmark stages")
    p.add_argument(
        "--stages",
        default="all",
        help="comma-separated stage-name prefixes (e.g. '1,2,6') or 'all'",
    )
    p.add_argument("--out", default="bench_results")
    p.add_argument("--timeout", type=int, default=300, help="per-stage seconds")
    p.add_argument("--isolate", action="store_true",
                   help="one fresh process per stage")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    if args.stages == "all":
        selected = dict(ALL_STAGES)
    else:
        prefixes = [s.strip() for s in args.stages.split(",")]
        selected = {
            k: v
            for k, v in ALL_STAGES.items()
            if any(k.startswith(pfx) for pfx in prefixes)
        }
    if not selected:
        print(f"no stages match {args.stages!r}; have {list(ALL_STAGES)}")
        return 1

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.isolate:
        return _run_isolated(selected, out_dir, args.timeout, args.device)

    summary = []
    for name, fn in selected.items():
        print(f"=== {name} ===", flush=True)
        rec = _run_stage(name, functools.partial(fn, device=args.device), args.timeout)
        (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
        if rec.get("skipped"):
            # say loudly when a stage could not measure anything (e.g.
            # collectives in one process)
            status = f"SKIPPED (not measured here): {rec['skipped']}"
        elif rec.get("ok"):
            status = "ok"
        else:
            status = f"FAILED: {rec.get('error')}"
        print(f"  {status} ({rec.get('wall_time_s', '-')}s)", flush=True)
        summary.append({
            "stage": name,
            "ok": rec.get("ok", False),
            **({"skipped": rec["skipped"]} if rec.get("skipped") else {}),
        })
    # a subset run (--stages 6) merges into an existing summary rather than
    # clobbering the full-suite record: update matching rows, keep the rest
    summary_path = out_dir / "summary.json"
    if args.stages != "all" and summary_path.exists():
        try:
            prior = {s["stage"]: s for s in json.loads(summary_path.read_text())}
        except (ValueError, KeyError, TypeError):
            prior = {}
        prior.update({s["stage"]: s for s in summary})
        summary = [prior[k] for k in ALL_STAGES if k in prior]
    summary_path.write_text(json.dumps(summary, indent=2))
    n_ok = sum(s["ok"] for s in summary)
    print(f"{n_ok}/{len(summary)} stages ok; results in {out_dir}/")
    return 0 if n_ok == len(summary) else 2


if __name__ == "__main__":
    sys.exit(main())
