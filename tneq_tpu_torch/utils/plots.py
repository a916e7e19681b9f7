"""Visual diagnostics: marginal-probability heatmap + sampling scatter PNGs.

Counterpart of ``tneq_tpu/utils/plots.py``.  Parity with the reference's
plotting diagnostics (``tests/test_probabilities.py:197-341``):
``test_heatmap_marginal`` renders P(q0, q1) over a 2-D value grid as a
``hot`` heatmap, and ``test_sampling`` scatters the first two coordinates
of inverse-CDF samples.  Everything renders through matplotlib's Agg
backend straight to PNG files; matplotlib is imported only when a PNG is
drawn, so :func:`marginal_grid` runs without it.

Usage::

    from tneq_tpu_torch.utils.plots import marginal_heatmap_png, sampling_scatter_png
    marginal_heatmap_png(graph, params, "heatmap.png", device="cpu")
    sampling_scatter_png(samples, "scatter.png")
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = ["marginal_grid", "marginal_heatmap_png", "sampling_scatter_png"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")  # render to files, no display
    import matplotlib.pyplot as plt

    return plt


def marginal_grid(
    graph,
    params,
    qubits: Tuple[int, int] = (0, 1),
    edge_size: int = 100,
    K: Optional[int] = None,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    states: Optional[Sequence] = None,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """``(edge_size, edge_size)`` float64 marginal probability P(x_q0, x_q1)
    over a uniform value grid (reference grid construction:
    ``test_probabilities.py:219-237`` — cell-centered, step = span/edge),
    computed on ``device`` (where ``params`` live).

    Identity operators trace out every other qubit, exactly the
    reference's ``calculate_marginal_probability`` call over ``[0, 1]``.
    """
    from ..infer import marginal_probability
    from ..ops import generate_data
    from ..train.trainer import basis_states

    dev = resolve_device(device)
    qa, qb = qubits
    lo, hi = bounds
    if K is None:
        K = graph.output_ranks[qa]
    if dtype is None:
        dtype = params[graph.core_names[0]].dtype
    step = (hi - lo) / edge_size
    centers = lo + step * (np.arange(edge_size) + 0.5)
    # row-major grid: row dx = value of qubit qa, column dy = qubit qb
    B = edge_size * edge_size
    x = np.zeros((B, 2), np.float32)
    x[:, 0], x[:, 1] = np.repeat(centers, edge_size), np.tile(centers, edge_size)
    mx_list, _ = generate_data(torch.as_tensor(x, device=dev), K, dtype=dtype)
    if states is None:
        states = basis_states(graph, dtype=dtype, device=dev)
    states = [torch.as_tensor(s, dtype=dtype, device=dev).expand((B,) + tuple(np.shape(s)))
              for s in states]
    p = marginal_probability(graph, params, states, [mx_list[0], mx_list[1]], [qa, qb])
    return p.detach().cpu().numpy().astype(np.float64).reshape(edge_size, edge_size)


def marginal_heatmap_png(
    graph,
    params,
    out_path: str,
    qubits: Tuple[int, int] = (0, 1),
    edge_size: int = 100,
    K: Optional[int] = None,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    states: Optional[Sequence] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Render the 2-qubit marginal heatmap to ``out_path``; returns the
    grid (reference: ``test_heatmap_marginal``, hot colormap + colorbar)."""
    heatmap = marginal_grid(graph, params, qubits, edge_size, K, bounds,
                            states, device=device)
    plt = _plt()
    fig = plt.figure()
    plt.imshow(heatmap, cmap="hot", interpolation="nearest")
    plt.colorbar()
    plt.title(f"Marginal Probability Heatmap (q{qubits[0]}, q{qubits[1]})")
    fig.savefig(out_path)
    plt.close(fig)
    return heatmap


def sampling_scatter_png(
    samples,
    out_path: str,
    bounds: Tuple[float, float] = (-5.0, 5.0),
    qubits: Tuple[int, int] = (0, 1),
) -> None:
    """Scatter plot of two coordinates of ``(S, nqubits)`` samples
    (reference: ``test_sampling`` plotting block,
    ``test_probabilities.py:308-330``)."""
    s = samples.detach().cpu().numpy() if isinstance(samples, torch.Tensor) else np.asarray(samples)
    if s.ndim != 2 or s.shape[1] <= max(qubits):
        raise ValueError(f"samples shape {s.shape} lacks qubits {qubits}")
    plt = _plt()
    fig = plt.figure(figsize=(8, 8))
    plt.scatter(s[:, qubits[0]], s[:, qubits[1]], alpha=0.6, s=10, c="blue",
                edgecolors="none")
    plt.xlim(*bounds)
    plt.ylim(*bounds)
    plt.title(f"Sampled Points (N={s.shape[0]})\nQubits {qubits[0]}, "
              f"{qubits[1]}")
    plt.xlabel(f"Qubit {qubits[0]}")
    plt.ylabel(f"Qubit {qubits[1]}")
    plt.axhline(0, color="grey", linewidth=0.5)
    plt.axvline(0, color="grey", linewidth=0.5)
    plt.grid(True, alpha=0.3)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
