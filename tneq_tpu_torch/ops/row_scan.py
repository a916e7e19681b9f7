"""Row-sweep overlap contraction for layered 2-local circuits (brick wall,
wall_col).

Counterpart of ``tneq_tpu/ops/row_scan.py``.  The two-network overlap
⟨A, B⟩ is contracted as a boundary sweep over QUBIT ROWS: the environment
between rows q and q+1 carries the row-(q+1) legs of the cores spanning
that cut (``r^(4·n_cells)`` entries, independent of the qubit count), and
each row absorbs its cores in one einsum, planned as pairwise steps under a
memory cap of a small multiple of the environment
(``ops/pairwise.choose_path``).  A max-abs rescale after every row
(detached scales) keeps the sweep float32-stable at any depth, with exact
gradients of the LOG overlap.

JAX runs the identical bulk rows as one ``lax.scan`` over stacked cores
and rematerialises every row (``jax.checkpoint``) to keep its program small
and its tile-padded residuals in HBM; the port runs the whole sweep, every
row's steps and rescale, as one ``torch.autograd.Function`` (:class:`_Sweep`)
with a hand-written backward (:class:`_SweepBwd`) over the values it saves.
Under ``torch.func.vmap`` (the batched prune's lanes) its vmap rule runs the
lanes together, so a step is one launch for all lanes and the transforms'
per-op cost is paid once per overlap, not per step.

**Gate steps.**  A step that contracts adjacent legs of a large environment
(>= ``MIN_GATE_ENV`` entries) with one small gate (``K·N <= MAX_GATE_KN``
for K contracted and N new entries), possibly across one diagonal of the
environment, is a gate step (:class:`GateForm`, marked by
:func:`_schedule` from the plan's shapes alone).  In float32 and complex64
it runs as the hand-written kernels of ``csrc/row_gate.cu`` for CUDA
tensors (:func:`_gate_fwd_cuda`, :func:`_gate_bwd_cuda`; a CUDA tensor
launches or raises) and as plain PyTorch for CPU ones
(:func:`_gate_fwd_plain`, :func:`_gate_bwd_plain`).  The B side's
conjugation is a flag to the kernel, not a copy.  Every other step, and
every step in another dtype, is a ``torch.einsum``.  :func:`launch_counts`
counts the kernels' launches and the steps that ran as einsum.

Applies to graphs where every core spans exactly two adjacent qubit rows;
:func:`supports_row_scan` reports applicability, and callers take the
generic pairwise executor otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import string
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph.dsl import CircuitGraph, get_symbol
from ..utils.profiling import annotate
from . import cuda_build
from .pairwise import (
    _TINY,
    CUDA_MAX_DIMS,
    _index_sizes,
    _lettered,
    _linear_path,
    choose_path,
    pairwise_steps,
)

__all__ = [
    "MAX_ENV_ELEMENTS",
    "GateForm",
    "build_row_steps",
    "gate_forms",
    "launch_counts",
    "make_row_scan_log_overlap_fn",
    "reset_launch_counts",
    "same_topology",
    "supports_row_scan",
]

# env entries beyond this are refused (r^(4*n_cells) grows with depth; the
# generic pairwise path handles deep-narrow circuits instead)
MAX_ENV_ELEMENTS = 1 << 24

# A gate step's environment has at least this many entries a lane, and its
# gate at most this many (K contracted times N new); the dtypes the kernels
# take (csrc/row_gate.cu)
MIN_GATE_ENV = 4096
MAX_GATE_KN = 256
KERNEL_DTYPES = (torch.float32, torch.complex64)
# the kernels' launch plan (csrc/row_gate.cu, which mirrors it)
THREADS = 256  # threads per CTA (kThreads)
FREE_DIMS = 24  # free dims after merging (kMaxFree): every leg of a 2^24 env
GATE_LEGS = 8  # k legs and n legs of size >= 2 (kMaxLegs)
CTAS_PER_SM = 4  # CTAs a launch aims to hold on each of the card's SMs
SMEM_TILE = 48 * 1024  # the staged tile's shared memory, at most (where 32 positions fit)

# launches of each kernel, counted by the wrappers where they launch, and
# the planned steps that ran as torch.einsum
_LAUNCHES: Dict[str, int] = {"row_gate_fwd": 0, "row_gate_bwd": 0, "row_step_einsum": 0}
_LAUNCH_LOCK = threading.Lock()  # farm workers launch from several threads


def launch_counts() -> Dict[str, int]:
    """Gate-step kernel launches (``row_gate_fwd``, ``row_gate_bwd``) and
    einsum steps (``row_step_einsum``) since :func:`reset_launch_counts`."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[name] += 1


def _core_rows(core) -> Tuple[int, ...]:
    return tuple(sorted({e.qubit for e in core.in_edges + core.out_edges}))


def same_topology(graph_a: CircuitGraph, graph_b: CircuitGraph) -> bool:
    """True when the two graphs differ at most in INTERNAL bond ranks: same
    cores and names, same wiring (qubit and neighbour per slot), same
    boundary-leg ranks.  The overlap of such a pair is well-defined."""
    if graph_a.nqubits != graph_b.nqubits or graph_a.ncores != graph_b.ncores:
        return False
    for ca, cb in zip(graph_a.cores, graph_b.cores):
        if ca.name != cb.name:
            return False
        for ea_list, eb_list in ((ca.in_edges, cb.in_edges), (ca.out_edges, cb.out_edges)):
            if len(ea_list) != len(eb_list):
                return False
            for ea, eb in zip(ea_list, eb_list):
                if ea.qubit != eb.qubit or ea.neighbor != eb.neighbor:
                    return False
                if ea.neighbor == -1 and ea.rank != eb.rank:
                    return False
    return True


def supports_row_scan(
    graph: CircuitGraph, graph_b: Optional[CircuitGraph] = None
) -> bool:
    """True when every core spans exactly two ADJACENT qubit rows, every
    cut has a core, and the cut environments stay within
    ``MAX_ENV_ELEMENTS`` (A-side times B-side leg ranks with ``graph_b``,
    which must have the same topology)."""
    if graph_b is not None and not same_topology(graph, graph_b):
        return False
    if graph.nqubits < 3:
        return False
    gb = graph_b if graph_b is not None else graph
    cuts: Dict[int, List[int]] = {}
    for core in graph.cores:
        rows = _core_rows(core)
        if len(rows) != 2 or rows[1] != rows[0] + 1:
            return False
        cuts.setdefault(rows[0], []).append(core.index)
    for q in range(graph.nqubits - 1):
        if q not in cuts:
            return False
    for q, idxs in cuts.items():
        size_a = size_b = 1
        for i in idxs:
            for e in graph.cores[i].in_edges + graph.cores[i].out_edges:
                if e.qubit == q + 1:
                    size_a *= e.rank
            for e in gb.cores[i].in_edges + gb.cores[i].out_edges:
                if e.qubit == q + 1:
                    size_b *= e.rank
        if size_a * size_b > MAX_ENV_ELEMENTS:
            return False
    return True


class _Sym:
    def __init__(self):
        self.n = 0

    def next(self) -> str:
        s = get_symbol(self.n)
        self.n += 1
        return s


def _row_order(graph: CircuitGraph, idxs: List[int], q: int) -> List[int]:
    """Cut-q cores ordered along the row (the row-q chain's order)."""
    chain = [graph.name_to_index[n] for n in graph.qubit_cores(q)]
    pos = {i: k for k, i in enumerate(chain)}
    return sorted(idxs, key=lambda i: pos[i])


def build_row_steps(graph: CircuitGraph, graph_b: Optional[CircuitGraph] = None):
    """Resolve the row sweep into per-row einsums, as JAX does.

    Returns a list over rows q = 0..n-1 of dicts with ``equation`` (over
    [env?, A-cores..., B-cores...]), ``cores`` (cut-q core names in row
    order; empty for the last row), ``has_env``, ``env_in_shape`` and
    ``env_out_shape``.  Each row's output axes are the env axes the next
    row consumes, in order.  ``graph_b``: the B side when its internal bond
    ranks differ from A's; equations are rank-agnostic, only the env shapes
    depend on it.
    """
    net_graph = {"A": graph, "B": graph_b if graph_b is not None else graph}
    n = graph.nqubits
    cuts: Dict[int, List[int]] = {}
    for core in graph.cores:
        rows = _core_rows(core)
        cuts.setdefault(rows[0], []).append(core.index)
    cut_order = {q: _row_order(graph, idxs, q) for q, idxs in cuts.items()}

    def edge_class(net: str, core_idx: int, e, is_out: bool):
        """Boundary edges glue A and B (the class ignores the net); internal
        bonds pair the two endpoint cores within a network."""
        if e.neighbor == -1:
            return ("bnd", e.qubit, "out" if is_out else "in")
        a, b = sorted((core_idx, e.neighbor))
        return ("bond", net, e.qubit, a, b)

    def axis_rank(net, ci, ref):
        is_out, pos = ref
        core = net_graph[net].cores[ci]
        return (core.out_edges if is_out else core.in_edges)[pos].rank

    steps = []
    # env_axes: (net, core_idx, (is_out, position)) of the legs on row q+1
    # whose symbols the next row reuses
    env_axes: List[Tuple[str, int, Tuple[bool, int]]] = []
    for q in range(n):
        sym = _Sym()
        class_syms: Dict[object, str] = {}

        def sym_for(cls):
            if cls not in class_syms:
                class_syms[cls] = sym.next()
            return class_syms[cls]

        env_subscript = ""
        for net, ci, (is_out, pos) in env_axes:
            core = graph.cores[ci]
            e = (core.out_edges if is_out else core.in_edges)[pos]
            assert e.qubit == q, (q, net, ci, e)
            env_subscript += sym_for(edge_class(net, ci, e, is_out))

        new_idxs = cut_order.get(q, [])
        core_subs = {}
        next_env: List[Tuple[str, int, Tuple[bool, int]]] = []
        out_syms: List[str] = []
        for net in ("A", "B"):
            for ci in new_idxs:
                core = graph.cores[ci]
                sub = ""
                for is_out, edges in ((False, core.in_edges), (True, core.out_edges)):
                    for pos, e in enumerate(edges):
                        if e.qubit == q:
                            sub += sym_for(edge_class(net, ci, e, is_out))
                        else:  # row q+1: an open env leg
                            s = sym.next()
                            sub += s
                            out_syms.append(s)
                            next_env.append((net, ci, (is_out, pos)))
                core_subs[(net, ci)] = sub

        operands = [env_subscript] if env_axes else []
        for net in ("A", "B"):
            for ci in new_idxs:
                operands.append(core_subs[(net, ci)])
        steps.append({
            "equation": ",".join(operands) + "->" + "".join(out_syms),
            "cores": [graph.cores[ci].name for ci in new_idxs],
            "has_env": bool(env_axes),
            "env_in_shape": tuple(axis_rank(*ax) for ax in env_axes),
            "env_out_shape": tuple(axis_rank(*ax) for ax in next_env),
        })
        env_axes = next_env
    assert not env_axes, "sweep did not close"
    return steps


# ---------------------------------------------------------------------------
# Gate steps: the plan, plain versions, kernel wrappers, autograd
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GateForm:
    """One planned gate step: ``out = einsum(e,g->o)`` for the environment
    ``env`` (legs ``e``, with the diagonal letter ``d`` twice when it has
    one) and the gate (legs ``g`` = ``k`` contracted + ``n`` new).  ``big``
    is the environment's position in the pairwise step; ``f`` the free legs
    (in ``e`` order); ``sizes`` every leg's extent.  The ``*_eq`` fields are
    the plain version's einsums, lettered a-zA-Z, over leading lane axes.
    A dataclass, not a pytree: autograd and vmap pass it through whole."""

    big: int
    e: str
    g: str
    o: str
    k: str
    n: str
    f: str
    d: str
    sizes: Tuple[Tuple[str, int], ...]
    fwd_eq: str
    denv_eq: str
    dgate_eq: str

    def size(self, legs: str) -> int:
        sizes = dict(self.sizes)
        return math.prod(sizes[c] for c in legs)

    def shape(self, legs: str) -> Tuple[int, ...]:
        sizes = dict(self.sizes)
        return tuple(sizes[c] for c in legs)


def _gate_form(equation: str, dims: Dict[str, int]) -> Optional[GateForm]:
    """The step ``equation`` as a gate step, or None (it stays an einsum).
    A gate step has one operand of >= ``MIN_GATE_ENV`` entries (the
    environment) whose every leg is free (in the output), contracted with
    the other operand (the gate) on adjacent legs, or one diagonal leg that
    appears twice and nowhere else; the gate's other legs are new, none
    repeats, and K·N <= ``MAX_GATE_KN``."""
    (a, b), o = equation.split("->")[0].split(","), equation.split("->")[1]
    sizes = [math.prod(dims[c] for c in t) for t in (a, b)]
    big = 0 if sizes[0] >= sizes[1] else 1
    e, g = (a, b) if big == 0 else (b, a)
    if sizes[big] < MIN_GATE_ENV or len(set(g)) != len(g) or len(set(o)) != len(o):
        return None
    twice = [c for c in set(e) if e.count(c) == 2]
    if any(e.count(c) > 2 for c in e) or len(twice) > 1:
        return None
    d = twice[0] if twice else ""
    if d and (d in g or d in o):
        return None
    k = "".join(c for c in e if c in g)
    n = "".join(c for c in g if c not in e)
    f = "".join(c for c in e if c != d and c not in g)
    if not k or any(c in o for c in k) or set(o) != set(f) | set(n):
        return None
    pos = [e.index(c) for c in k]
    if max(pos) - min(pos) != len(k) - 1:  # the contracted legs are adjacent
        return None
    if math.prod(dims[c] for c in g) > MAX_GATE_KN:
        return None
    names = {c: string.ascii_letters[i] for i, c in enumerate(dict.fromkeys(e + g + o))}

    def lt(t: str) -> str:
        return "..." + "".join(names[c] for c in t)

    e0 = e.replace(d, "") if d else e  # without the diagonal
    return GateForm(
        big=big, e=e, g=g, o=o, k=k, n=n, f=f, d=d,
        sizes=tuple((c, dims[c]) for c in dict.fromkeys(e + g)),
        fwd_eq=f"{lt(e)},{lt(g)}->{lt(o)}",
        denv_eq=f"{lt(o)},{lt(g)}->{lt(e0)}",
        dgate_eq=f"{lt(e)},{lt(o)}->{lt(g)}",
    )


def _gate_fwd_plain(env, gate, form: GateForm, conj: bool):
    """The gate step in plain PyTorch: ``out = einsum(env, gate')`` with
    ``gate' = conj(gate)`` when ``conj``, over leading lane axes."""
    return torch.einsum(form.fwd_eq, env, gate.conj() if conj else gate)


def _gate_bwd_plain(env, gate, dout, form: GateForm, conj: bool, need_env: bool,
                    need_gate: bool):
    """Its VJP in plain PyTorch: ``(d_env | None, d_gate | None)``; a
    diagonal's gradient lies on the diagonal, zero off it."""
    d_env = d_gate = None
    if need_env:
        d_env = torch.einsum(form.denv_eq, dout, gate if conj else gate.conj())
        if form.d:
            lead = dout.dim() - len(form.o)
            p1, p2 = form.e.index(form.d), form.e.rindex(form.d)
            full = d_env.new_zeros(d_env.shape[:lead] + form.shape(form.e))
            diag = torch.diagonal(full, 0, lead + p1, lead + p2)
            diag.copy_(d_env.unsqueeze(-1).expand_as(diag))
            d_env = full
    if need_gate:
        d_gate = torch.einsum(form.dgate_eq, env.conj(), dout)
        d_gate = d_gate.conj() if conj else d_gate
    return d_env, d_gate


class _Desc(ctypes.Structure):
    """``RowGateDesc`` of ``csrc/row_gate.cu``: one launch's lanes, extents
    and strides (in elements)."""

    _fields_ = (
        [(n, ctypes.c_longlong) for n in ("lane_e", "lane_g", "lane_o", "lane_do", "lane_de",
                                          "lane_dg")]
        + [(n, ctypes.c_int) for n in ("lanes", "F", "K", "N", "D", "conj", "tile", "blocks",
                                       "k_fast_e", "n_fast_o", "n_fast_do", "k_fast_de",
                                       "d_e", "d_de1", "d_de2", "nf", "nk", "nn")]
        + [(n, ctypes.c_int * FREE_DIMS) for n in ("f_size", "f_e", "f_o", "f_do", "f_de")]
        + [(n, ctypes.c_int * GATE_LEGS) for n in ("k_size", "k_e", "k_g", "k_de", "k_dg",
                                                   "n_size", "n_g", "n_o", "n_do", "n_dg")]
    )


def _contiguous_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _lane_stride(shape: Tuple[int, ...], strides: Tuple[int, ...]) -> int:
    """One stride for the leading lane axes, which must merge into one."""
    lane = 0
    inner = None  # (size, stride) of the innermost lane axis of size > 1
    for size, st in reversed(list(zip(shape, strides))):
        if size == 1:
            continue
        if inner is None:
            lane = st
        elif st != inner[0] * inner[1]:
            raise ValueError(f"the gate kernels take lane axes that merge into one; got shape "
                             f"{shape}, strides {strides}")
        inner = (size, st)
    return lane


@functools.lru_cache(maxsize=4096)
def _describe(form: GateForm, lanes: int, backward: bool, conj: bool, elem: int,
              lane_strides: Tuple[int, ...], e_st: Tuple[int, ...], g_st: Tuple[int, ...],
              o_st: Tuple[int, ...], sms: int):
    """``(descriptor, blocks)`` of one launch on a card of ``sms`` SMs.
    ``o_st``: the output's strides (forward) or dO's (backward);
    ``lane_strides``: (env, gate, out or dO); O, dE and dG are written
    contiguous.  Legs of size 1 are dropped and free legs merged where
    every tensor allows.  Raises ``ValueError`` where the kernels cannot
    take the launch."""
    sizes = dict(form.sizes)
    e_of = {}
    for i, c in enumerate(form.e):
        e_of.setdefault(c, []).append(i)
    de_st = _contiguous_strides(form.shape(form.e))
    dg_st = _contiguous_strides(form.shape(form.g))
    K, N = form.size(form.k), form.size(form.n)
    if K * N > MAX_GATE_KN:
        raise ValueError(f"the gate kernels take K·N <= {MAX_GATE_KN}, got {K}·{N}")
    d = _Desc()
    d.lanes, d.K, d.N, d.conj = lanes, K, N, int(conj)
    d.lane_e, d.lane_g = lane_strides[0], lane_strides[1]
    if backward:
        d.lane_do = lane_strides[2]
        d.lane_de, d.lane_dg = math.prod(sizes[c] for c in form.e), K * N
    else:
        d.lane_o = lane_strides[2]
    # free legs, outermost first in the environment's memory order, merged
    legs = [c for c in form.f if sizes[c] > 1]
    legs.sort(key=lambda c: -e_st[e_of[c][0]])
    cols = [("e", lambda c: e_st[e_of[c][0]]), ("o", lambda c: o_st[form.o.index(c)])]
    if backward:
        cols.append(("de", lambda c: de_st[e_of[c][0]]))
    dims = []  # [size, {col: stride}]
    for c in legs:
        st = {name: fn(c) for name, fn in cols}
        if dims and all(dims[-1][1][m] == st[m] * sizes[c] for m in st):
            dims[-1][0] *= sizes[c]
            dims[-1][1] = st
        else:
            dims.append([sizes[c], st])
    if len(dims) > FREE_DIMS:
        raise ValueError(f"the gate kernels take at most {FREE_DIMS} free dims, got {len(dims)}")
    d.nf = len(dims)
    d.F = math.prod(s for s, _ in dims)
    for j, (s, st) in enumerate(dims):
        d.f_size[j], d.f_e[j] = s, st["e"]
        if backward:
            d.f_do[j], d.f_de[j] = st["o"], st["de"]
        else:
            d.f_o[j] = st["o"]
    ks = [c for c in form.k if sizes[c] > 1]
    ns = [c for c in form.n if sizes[c] > 1]
    d.nk, d.nn = len(ks), len(ns)
    for j, c in enumerate(ks):
        d.k_size[j], d.k_e[j], d.k_g[j] = sizes[c], e_st[e_of[c][0]], g_st[form.g.index(c)]
        d.k_de[j], d.k_dg[j] = de_st[e_of[c][0]], dg_st[form.g.index(c)]
    for j, c in enumerate(ns):
        d.n_size[j], d.n_g[j], d.n_dg[j] = sizes[c], g_st[form.g.index(c)], dg_st[form.g.index(c)]
        if backward:
            d.n_do[j] = o_st[form.o.index(c)]
        else:
            d.n_o[j] = o_st[form.o.index(c)]
    d.D = sizes[form.d] if form.d else 1
    if d.D > 1:
        p1, p2 = e_of[form.d]
        d.d_e, d.d_de1, d.d_de2 = e_st[p1] + e_st[p2], de_st[p1], de_st[p2]
    # the loops over (position, value) run the operand's innermost axis fastest
    last = {m: dims[-1][1][m] if dims else 1 << 62 for m, _ in cols}
    d.k_fast_e = int(bool(ks) and d.k_e[d.nk - 1] < last["e"])
    if backward:
        d.n_fast_do = int(bool(ns) and d.n_do[d.nn - 1] < last["o"])
        d.k_fast_de = int(bool(ks) and d.k_de[d.nk - 1] < last["de"])
    else:
        d.n_fast_o = int(bool(ns) and d.n_o[d.nn - 1] < last["o"])
    # offsets within a lane are 32-bit
    reach = [sum((s - 1) * st[m] for s, st in dims) for m, _ in cols]
    reach.append(sum((sizes[c] - 1) * e_st[e_of[c][0]] for c in ks) + (d.D - 1) * d.d_e)
    if max(reach) + math.prod(sizes[c] for c in form.e) >= 1 << 31:
        raise ValueError("the gate kernels take lanes of fewer than 2^31 elements")
    tile = THREADS
    while tile > 32 and (K + N) * (tile + 1) * elem > SMEM_TILE:
        tile //= 2
    d.tile = tile
    d.blocks = max(1, min(-(-d.F // tile), -(-sms * CTAS_PER_SM // lanes)))
    return d, d.blocks


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tneq_row_gate_desc_size": [],
    # device, desc, is_complex, E, G, O, stream
    "tneq_row_gate_fwd": [_I, ctypes.POINTER(_Desc), _I, _P, _P, _P, _P],
    # device, desc, is_complex, E, G, dO, dE, dG, partial, counter, stream
    "tneq_row_gate_bwd": [_I, ctypes.POINTER(_Desc), _I, _P, _P, _P, _P, _P, _P, _P, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The gate-step library with its C signatures declared."""
    lib = cuda_build.library("row_gate")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    if lib.tneq_row_gate_desc_size() != ctypes.sizeof(_Desc):
        raise RuntimeError("csrc/row_gate.cu's RowGateDesc does not match ops/row_scan._Desc")
    return lib


@functools.cache
def _sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}  # (device, stream) -> zeroed counter
_COUNTER_LOCK = threading.Lock()


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    """The d_gate reduction's completion counter of a stream: zeroed once,
    left zeroed by every launch (launches on one stream run in order)."""
    key = (device.index, stream)
    with _COUNTER_LOCK:
        if key not in _COUNTERS:
            _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return _COUNTERS[key]


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _check(form: GateForm, env, gate, other, other_legs: str):
    """The lanes' shape (the axes in front of the environment's legs);
    raises ``ValueError`` where the kernels cannot take the tensors."""
    if env.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the gate kernels take float32 or complex64, got {env.dtype}")
    lead_n = env.dim() - len(form.e)
    lead = tuple(env.shape[:lead_n])
    for name, t, legs in (("env", env, form.e), ("gate", gate, form.g), ("out", other, other_legs)):
        if t.device != env.device or t.dtype != env.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected {env.dtype} on "
                             f"{env.device}")
        if tuple(t.shape) != lead + form.shape(legs):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{lead + form.shape(legs)}")
    return lead


def _gate_fwd_cuda(env, gate, form: GateForm, conj: bool):
    """Launch the forward kernel once for all lanes; same output as the
    plain version, written contiguous."""
    lead_n = env.dim() - len(form.e)
    out = torch.empty(tuple(env.shape[:lead_n]) + form.shape(form.o), dtype=env.dtype,
                      device=env.device)
    lead = _check(form, env, gate, out, form.o)
    lanes = math.prod(lead)
    lane_st = tuple(_lane_stride(lead, t.stride()[:lead_n]) for t in (env, gate, out))
    desc, _ = _describe(form, lanes, False, conj, env.element_size(), lane_st,
                        env.stride()[lead_n:], gate.stride()[lead_n:], out.stride()[lead_n:],
                        _sms(env.device.index))
    stream = torch.cuda.current_stream(env.device).cuda_stream
    err = _lib().tneq_row_gate_fwd(env.device.index, ctypes.byref(desc),
                                   int(env.is_complex()), _ptr(env), _ptr(gate), _ptr(out),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"row_gate_fwd launch failed: CUDA error {err}")
    _count("row_gate_fwd")
    return out


def _gate_bwd_cuda(env, gate, dout, form: GateForm, conj: bool, need_env: bool,
                   need_gate: bool):
    """Launch the backward kernel once for all lanes: d_env and the
    deterministic two-stage d_gate reduction in one launch."""
    lead = _check(form, env, gate, dout, form.o)
    lead_n, lanes = len(lead), math.prod(lead)
    lane_st = tuple(_lane_stride(lead, t.stride()[:lead_n]) for t in (env, gate, dout))
    desc, blocks = _describe(form, lanes, True, conj, env.element_size(), lane_st,
                             env.stride()[lead_n:], gate.stride()[lead_n:],
                             dout.stride()[lead_n:], _sms(env.device.index))
    kw = dict(dtype=env.dtype, device=env.device)
    d_env = torch.empty(lead + form.shape(form.e), **kw) if need_env else None
    d_gate = torch.empty(lead + form.shape(form.g), **kw) if need_gate else None
    stream = torch.cuda.current_stream(env.device).cuda_stream
    partial = counter = None
    if need_gate:
        partial = torch.empty(lanes * blocks * desc.K * desc.N, **kw)
        counter = _counter(env.device, stream)
    err = _lib().tneq_row_gate_bwd(env.device.index, ctypes.byref(desc),
                                   int(env.is_complex()), _ptr(env), _ptr(gate), _ptr(dout),
                                   _ptr(d_env), _ptr(d_gate), _ptr(partial), _ptr(counter),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"row_gate_bwd launch failed: CUDA error {err}")
    _count("row_gate_bwd")
    return d_env, d_gate


def _route(t: torch.Tensor, plain, kernel):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no gate-step path for device {t.device}")


def _lanes_first(batch_size: int, in_dims, args):
    """torch.func.vmap's lane axis of each tensor moved to the front, an
    unbatched tensor expanded (lane stride 0); nothing is copied."""
    return [x.expand((batch_size,) + tuple(x.shape)) if d is None else x.movedim(d, 0)
            for x, d in zip(args, in_dims)]


class _Row(NamedTuple):
    cores: Tuple[str, ...]
    has_env: bool
    equation: str
    steps: Optional[tuple]  # pairwise steps; None: one operand, one einsum
    gates: Optional[tuple]  # per step: its GateForm, or None (an einsum)


@functools.lru_cache(maxsize=64)
def _schedule(graph: CircuitGraph, graph_b: Optional[CircuitGraph]) -> Tuple[_Row, ...]:
    """The rows of the sweep with their pairwise plans.  A row of more than
    two operands is planned by ``choose_path`` under the cap
    ``max(64·env, 2^16)``, env the larger of its in and out environments:
    JAX's tight guard, which keeps every intermediate within a small
    multiple of the environment.  Each step is marked a gate step
    (:func:`_gate_form`) or not, from its shapes alone."""
    gb = graph_b if graph_b is not None else graph
    rows = []
    for step in build_row_steps(graph, graph_b):
        shapes = [step["env_in_shape"]] if step["has_env"] else []
        shapes += [graph.shapes[nm] for nm in step["cores"]]
        shapes += [gb.shapes[nm] for nm in step["cores"]]
        eq = step["equation"]
        cap = max(
            int(np.prod(step["env_in_shape"], dtype=np.int64)),
            int(np.prod(step["env_out_shape"], dtype=np.int64)),
        )
        cap = max(64 * cap, 1 << 16)
        if len(shapes) == 1:
            plan = None
        elif len(shapes) == 2:
            plan = tuple(pairwise_steps(eq, _linear_path(2)))
        else:
            plan = tuple(pairwise_steps(eq, list(choose_path(eq, tuple(shapes), cap))))
        gates = None
        if plan is not None:
            dims = _index_sizes(eq, shapes)
            gates = tuple(_gate_form(step_eq, dims) for _, _, step_eq in plan)
        rows.append(_Row(tuple(step["cores"]), step["has_env"], eq, plan, gates))
    return tuple(rows)


def gate_forms(graph: CircuitGraph, graph_b: Optional[CircuitGraph] = None
               ) -> Dict[Tuple[int, int, bool, int], Tuple[str, GateForm]]:
    """The first planned gate step of each form of the overlap's sweep,
    ``{(K, N, diagonal, big): (step equation, GateForm)}``, in plan order."""
    forms = {}
    for row in _schedule(graph, graph_b):
        for (_, _, eq), form in zip(row.steps or (), row.gates or ()):
            if form is not None:
                key = (form.size(form.k), form.size(form.n), bool(form.d), form.big)
                forms.setdefault(key, (eq, form))
    return forms


class _Step(NamedTuple):
    """One step of the sweep over value slots: ``out = einsum(a, b)`` (``b``
    None: a one-operand einsum), ``form`` a GateForm or None, ``conj_a`` /
    ``conj_b`` the operands' conjugation (the B side's cores)."""

    a: int
    b: Optional[int]
    out: int
    equation: str  # lettered a-zA-Z over leading lane axes ("...")
    rank: int  # the largest term's rank, lane axes not counted
    form: Optional[GateForm]
    conj_a: bool
    conj_b: bool


@dataclasses.dataclass(frozen=True)
class _Program:
    """The whole sweep over value slots, for :class:`_Sweep`: slots ``0 ..
    2·n - 1`` are the A cores then the B cores (``names`` order), the rest
    are intermediates.  Each row runs its steps, then rescales its last
    value (slot ``raw[r]``) into ``scaled[r]`` by the row's scale.  A
    dataclass, not a pytree: autograd and vmap pass it through whole."""

    names: Tuple[str, ...]
    rows: Tuple[Tuple[_Step, ...], ...]
    raw: Tuple[int, ...]
    scaled: Tuple[int, ...]
    slots: int
    saved: Tuple[int, ...]  # intermediates a step reads: kept for the backward
    ndim0: int  # the first core's legs: the axes in front of them are lanes


def _ellipsis(equation: str) -> Tuple[str, int]:
    """``equation`` lettered a-zA-Z over leading lane axes, and its largest
    term's rank."""
    lettered, rank = _lettered(equation)
    lhs, rhs = lettered.split("->")
    return ",".join("..." + t for t in lhs.split(",")) + "->..." + rhs, rank


@functools.lru_cache(maxsize=64)
def _program(graph: CircuitGraph, graph_b: Optional[CircuitGraph]) -> _Program:
    """:func:`_schedule`'s rows resolved into slot steps."""
    rows = _schedule(graph, graph_b)
    names = tuple(nm for row in rows for nm in row.cores)
    n = len(names)
    slot = {nm: i for i, nm in enumerate(names)}
    nxt, env = 2 * n, None
    out_rows, raws, scaleds, read = [], [], [], set()
    for row in rows:
        ops = ([env] if row.has_env else []) + [slot[nm] for nm in row.cores]
        ops += [n + slot[nm] for nm in row.cores]
        conj = [o is not None and n <= o < 2 * n for o in ops]  # the B side's cores
        steps = []
        if row.steps is None:
            eq, rank = _ellipsis(row.equation)
            steps.append(_Step(ops[0], None, nxt, eq, rank, None, conj[0], False))
            read.add(ops[0])
            ops, nxt = [nxt], nxt + 1
        else:
            for (i, j, step_eq), form in zip(row.steps, row.gates):
                eq, rank = _ellipsis(step_eq)
                steps.append(_Step(ops[i], ops[j], nxt, eq, rank, form, conj[i], conj[j]))
                read.update((ops[i], ops[j]))
                for lst in (ops, conj):
                    lst.pop(max(i, j))
                    lst.pop(min(i, j))
                ops.append(nxt)
                conj.append(False)
                nxt += 1
        out_rows.append(tuple(steps))
        raws.append(ops[0])
        scaleds.append(nxt)
        env, nxt = nxt, nxt + 1
    saved = tuple(sorted(s for s in read if s >= 2 * n))
    return _Program(names, tuple(out_rows), tuple(raws), tuple(scaleds), nxt, saved,
                    len(graph.shapes[names[0]]))


def _step_einsum(step: _Step, lead_n: int, a, b=None):
    """One step as ``torch.einsum`` on tensors with ``lead_n`` lane axes; on
    the card a term of more than ``CUDA_MAX_DIMS`` dimensions raises."""
    if a.is_cuda and step.rank + lead_n > CUDA_MAX_DIMS:
        raise ValueError(
            f"a pairwise step of this contraction has a rank-{step.rank} tensor with "
            f"{lead_n} lane axes; CUDA's elementwise kernels take at most {CUDA_MAX_DIMS} "
            f"dimensions")
    a = a.conj() if step.conj_a else a
    if b is None:
        return torch.einsum(step.equation, a)
    return torch.einsum(step.equation, a, b.conj() if step.conj_b else b)


def _takes_gate(step: _Step, value: torch.Tensor) -> bool:
    """A planned gate step in a dtype the kernels take, on an environment
    that is no conjugated core."""
    if step.form is None or value.dtype not in KERNEL_DTYPES:
        return False
    return not (step.conj_a if step.form.big == 0 else step.conj_b)


def _gate_operands(step: _Step):
    """``(env slot, gate slot, gate conjugated)`` of a gate step."""
    if step.form.big == 0:
        return step.a, step.b, step.conj_b
    return step.b, step.a, step.conj_a


def _sweep_forward(prog: _Program, cores):
    """The sweep on tensors with the same leading lane axes: ``(mantissa,
    logs, scales [..., rows], saved intermediates)``; the gate steps
    through the kernels for CUDA tensors and their plain versions for CPU
    ones, every other step as ``torch.einsum``."""
    dtype = functools.reduce(torch.promote_types, (c.dtype for c in cores))
    vals: List[Optional[torch.Tensor]] = [c.to(dtype) for c in cores]
    vals += [None] * (prog.slots - len(cores))
    lead_n = cores[0].dim() - prog.ndim0
    lead = tuple(cores[0].shape[:lead_n])
    logs, scales = None, []
    fwd = _route(cores[0], _gate_fwd_plain, _gate_fwd_cuda)
    for steps, raw, scaled in zip(prog.rows, prog.raw, prog.scaled):
        with annotate("row_sweep.row"):
            for st in steps:
                a = vals[st.a]
                if st.b is not None and _takes_gate(st, a):
                    env, gate, conj = _gate_operands(st)
                    vals[st.out] = fwd(vals[env], vals[gate], st.form, conj)
                else:
                    if st.b is not None:
                        _count("row_step_einsum")
                    vals[st.out] = _step_einsum(st, lead_n, a,
                                                None if st.b is None else vals[st.b])
            t, vals[raw] = vals[raw], None  # no step reads a row's unscaled value
            s = t.abs().reshape(lead + (-1,)).amax(-1) + _TINY
            vals[scaled] = t / s.reshape(lead + (1,) * (t.dim() - lead_n))
            logs = torch.log(s) if logs is None else logs + torch.log(s)
            scales.append(s)
    return vals[prog.scaled[-1]], logs, torch.stack(scales, -1), [vals[i] for i in prog.saved]


def _sweep_backward(prog: _Program, needs: Tuple[bool, ...], d_m, scales, cores, saved):
    """The sweep's VJP for the mantissa's gradient ``d_m`` (the scales held
    constant, as the forward detaches them): the gate steps through the
    backward kernel (plain version on the host), every other step by
    autograd through its einsum.  Returns one gradient (or None) per core."""
    lead_n = cores[0].dim() - prog.ndim0
    lead = tuple(cores[0].shape[:lead_n])
    dtype = functools.reduce(torch.promote_types, (c.dtype for c in cores))
    vals: List[Optional[torch.Tensor]] = [c.to(dtype) for c in cores]
    vals += [None] * (prog.slots - len(cores))
    for i, t in zip(prog.saved, saved):
        vals[i] = t
    need = list(needs) + [False] * (prog.slots - len(cores))
    for steps, raw, scaled in zip(prog.rows, prog.raw, prog.scaled):
        for st in steps:
            need[st.out] = need[st.a] or (st.b is not None and need[st.b])
        need[scaled] = need[raw]
    grads: List[Optional[torch.Tensor]] = [None] * prog.slots
    grads[prog.scaled[-1]] = d_m

    def add(slot, g):
        if g is not None:
            grads[slot] = g if grads[slot] is None else grads[slot] + g

    bwd = _route(cores[0], _gate_bwd_plain, _gate_bwd_cuda)
    for r in reversed(range(len(prog.rows))):
        g, grads[prog.scaled[r]] = grads[prog.scaled[r]], None
        if g is None or not need[prog.raw[r]]:
            continue
        s = scales[..., r]
        add(prog.raw[r], g / s.reshape(lead + (1,) * (g.dim() - lead_n)))
        for st in reversed(prog.rows[r]):
            g, grads[st.out] = grads[st.out], None  # each value's gradient, once used, goes
            if g is None:
                continue
            if st.b is not None and _takes_gate(st, vals[st.a]):
                env, gate, conj = _gate_operands(st)
                d_env, d_gate = bwd(vals[env], vals[gate], g, st.form, conj, need[env],
                                    need[gate])
                add(env, d_env)
                add(gate, d_gate)
                continue
            ins = [st.a] if st.b is None else [st.a, st.b]
            with torch.enable_grad():
                leaves = [vals[i].detach().requires_grad_(need[i]) for i in ins]
                t = _step_einsum(st, lead_n, *leaves)
                wanted = [(i, x) for i, x in zip(ins, leaves) if need[i]]
                got = torch.autograd.grad(t, [x for _, x in wanted], g)
            for (i, _), d in zip(wanted, got):
                add(i, d)
    out = []
    for c, d, n in zip(cores, grads, needs):
        if not n or d is None:
            out.append(None)
            continue
        if d.is_complex() and not c.is_complex():
            d = d.real
        out.append(d.to(c.dtype))
    return tuple(out)


class _Sweep(torch.autograd.Function):
    """``(program, *cores) -> (mantissa, logs, scales, *saved)``: the whole
    row sweep in one Function, A cores then B cores in ``program.names``
    order.  Only the mantissa is differentiable: the per-row scales are
    constants (detached max-abs rescales, exact for the LOG overlap), and
    scales and the saved intermediates are returned for the backward
    (:class:`_SweepBwd`).  Its vmap rule runs every lane of a
    ``torch.func.vmap`` at once: one launch per gate step for all lanes."""

    @staticmethod
    def forward(prog, *cores):
        m, logs, scales, saved = _sweep_forward(prog, cores)
        return (m, logs, scales, *saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        prog, *cores = inputs
        _, logs, scales, *saved = output
        ctx.prog = prog
        ctx.save_for_backward(scales, *cores, *saved)
        ctx.mark_non_differentiable(logs, scales, *saved)

    @staticmethod
    def backward(ctx, d_m, *_):
        scales, *rest = ctx.saved_tensors
        n = 2 * len(ctx.prog.names)
        needs = tuple(ctx.needs_input_grad[1:])
        grads = _SweepBwd.apply(ctx.prog, needs, d_m, scales, *rest[:n], *rest[n:])
        return (None, *grads)

    @staticmethod
    def vmap(info, in_dims, prog, *cores):
        out = _Sweep.apply(prog, *_lanes_first(info.batch_size, in_dims[1:], cores))
        return out, (0,) * len(out)


class _SweepBwd(torch.autograd.Function):
    """``(program, needs, d_mantissa, scales, *cores, *saved) -> one
    gradient per core (None where ``needs`` is False)``: the VJP of
    :class:`_Sweep`, with the same lanes and vmap rule; it has no
    derivative of its own."""

    @staticmethod
    def forward(prog, needs, d_m, scales, *rest):
        n = 2 * len(prog.names)
        return _sweep_backward(prog, needs, d_m, scales, rest[:n], rest[n:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError("the row sweep's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, prog, needs, *tensors):
        grads = _SweepBwd.apply(prog, needs, *_lanes_first(info.batch_size, in_dims[2:],
                                                          tensors))
        return grads, tuple(None if g is None else 0 for g in grads)


def make_row_scan_log_overlap_fn(
    graph: CircuitGraph,
    graph_b: Optional[CircuitGraph] = None,
    signed: bool = False,
):
    """fn(params_a, params_b) -> log|⟨A, B⟩| via the row sweep.

    B-side cores are conjugated (Hermitian overlap).  Raises ``ValueError``
    when the topology is unsupported (check :func:`supports_row_scan`).

    ``graph_b``: the B side with other internal bond ranks (same
    topology).  ``signed=True``: return ``(mantissa, log_scale)`` with
    ``value = mantissa·exp(log_scale)``, the form in which slice partials
    are summed.
    """
    if not supports_row_scan(graph, graph_b):
        raise ValueError("graph is not a layered 2-local circuit")
    prog = _program(graph, graph_b)

    def fn(params_a, params_b):
        with annotate("row_sweep.overlap"):
            cores = [params_a[nm] for nm in prog.names] + [params_b[nm] for nm in prog.names]
            m, logs = _Sweep.apply(prog, *cores)[:2]
            if signed:
                return m, logs
            return logs + torch.log(torch.abs(m) + _TINY)

    return fn
