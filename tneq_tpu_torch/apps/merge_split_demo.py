"""QCTN merge/split demo: dynamic circuit-topology restructuring.

Counterpart of ``tneq_tpu/apps/merge_split_demo.py``: split MPS / tree /
brick-wall circuits at core boundaries, merge them back, and check that the
weights were carried across (a contraction-norm fingerprint of the cores,
the sum of their absolute values).  ``--device`` (default ``cuda``) is where
the cores live; JAX's ``PRNGKey(0)`` becomes seed 0 of the port's
``init_params``.

    python -m tneq_tpu_torch.apps.merge_split_demo --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..graph.generators import example_graph
from ..model.qctn import QCTN
from ..utils.device import DeviceLike

__all__ = ["main", "demo"]


def _fingerprint(q: QCTN) -> float:
    return float(sum(float(v.abs().sum()) for v in q.params.values()))


def demo(graph_type: str, n: int, dim: int, split_idx: Optional[int],
         device: DeviceLike = "cuda") -> bool:
    src = example_graph(n, graph_type, dim)
    model = QCTN(src, seed=0, device=device)
    print(f"=== {graph_type}: {model.nqubits} qubits, {model.ncores} cores ===")
    print(src)
    try:
        left, right = model.split(split_idx)
    except ValueError as e:
        # interleaved layouts refuse to split — informational, not a failure
        print(f"split not possible: {e}")
        return True
    print(f"split -> left {left.ncores} cores {list(left.cores)}, "
          f"right {right.ncores} cores {list(right.cores)}")
    merged = left.merge_with(right)
    print(f"merged -> {merged.ncores} cores on {merged.nqubits} qubits")

    fp_orig = _fingerprint(model)
    fp_merged = _fingerprint(merged)
    ok = abs(fp_orig - fp_merged) < 1e-3 * max(1.0, abs(fp_orig))
    print(f"weight fingerprint: original={fp_orig:.6f} merged={fp_merged:.6f} "
          f"({'carried' if ok else 'MISMATCH'})")
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="QCTN merge/split demo")
    p.add_argument("--num-qubits", type=int, default=6)
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--split-idx", type=int, default=None)
    p.add_argument("--graph-types", nargs="*", default=["mps", "tree"])
    p.add_argument("--device", default="cuda",
                   help="where the cores live ('cpu' runs on the host)")
    args = p.parse_args(argv)
    results = [
        demo(g, args.num_qubits, args.dim, args.split_idx, args.device)
        for g in args.graph_types
    ]
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
