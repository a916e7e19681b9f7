"""Graph surgery and MutableGraph: the port against the JAX package on the
same DSL strings and the same numpy generators."""

import numpy as np
import pytest
import torch

from tneq_tpu.graph import generators as jgen
from tneq_tpu.graph.mutable import MutableGraph as JMutable
from tneq_tpu.graph.surgery import merge_graphs as j_merge
from tneq_tpu.graph.surgery import split_graph as j_split
from tneq_tpu.graph.surgery import with_bond_ranks as j_with_ranks
from tneq_tpu.model.qctn import QCTN as JQCTN
from tneq_tpu_torch.apps import merge_split_demo
from tneq_tpu_torch.genetic import Individual
from tneq_tpu_torch.graph import (
    MutableGraph,
    example_graph,
    merge_graphs,
    mps_graph,
    parse_graph,
    split_graph,
    tree_graph,
    wall_graph,
)
from tneq_tpu_torch.graph.surgery import with_bond_ranks
from tneq_tpu_torch.model.qctn import QCTN, params_to_numpy

torch.set_num_threads(1)

_DSLS = {
    "mps": mps_graph(6, 2),
    "tree": tree_graph(6, 2),
    "wall": wall_graph(5, layers=3, dim=2),
    "full": Individual.create_full_connection("f", tn_size=4, tn_rank=2).graph.to_dsl(),
}


def _outcome(fn):
    """``('ok', value)`` or ``('error', message)`` of ``fn()``."""
    try:
        return "ok", fn()
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("kind", sorted(_DSLS))
def test_mutations_match_jax_step_by_step(kind):
    """~50 seeded mutations of every primitive and mode: the same lines,
    the same DSL (or the same ValueError) after every step."""
    src = _DSLS[kind]
    ours, theirs = MutableGraph(src), JMutable(src)
    assert ours.lines == theirs.lines and ours.to_dsl() == theirs.to_dsl()
    drive = np.random.default_rng(5)
    rng_ours, rng_theirs = np.random.default_rng(11), np.random.default_rng(11)
    errors = 0
    for _ in range(50):
        q = int(drive.integers(0, ours.n_qubits))
        names = [n for n, _, _ in ours.lines[q]] + ["", "Z"]
        name = names[int(drive.integers(0, len(names)))]
        op = int(drive.integers(0, 3))
        if op == 0:
            v = int(drive.choice([0, 2, 3]))
            got = [_outcome(lambda g=g: g.modify_bond(q, name, v)) for g in (ours, theirs)]
        elif op == 1:
            mode = str(drive.choice(["min", "max", "left", "right", "bogus"]))
            got = [_outcome(lambda g=g: g.remove_tensor_from_qubit(q, name, mode))
                   for g in (ours, theirs)]
        else:
            mode = str(drive.choice(["random", "first", "last", "middle"]))
            got = [_outcome(lambda g=g, r=r: g.insert_tensor_after(q, name, mode, rng=r))
                   for g, r in ((ours, rng_ours), (theirs, rng_theirs))]
        assert got[0] == got[1]
        errors += got[0][0] == "error"
        assert ours.lines == theirs.lines
        assert _outcome(ours.to_dsl) == _outcome(theirs.to_dsl)
        assert ours.tensor_names == theirs.tensor_names
        for t in ours.tensor_names:
            assert ours.tensor_qubits(t) == theirs.tensor_qubits(t)
    assert 0 < errors < 50  # both paths were taken


def test_empty_and_unset_lines_raise_like_jax():
    for g in (MutableGraph(n_qubits=2), JMutable(n_qubits=2)):
        with pytest.raises(ValueError, match="no tensors"):
            g.to_dsl()
    ours, theirs = MutableGraph("-2-A-2-"), JMutable("-2-A-2-")
    for g in (ours, theirs):
        with pytest.raises(ValueError, match="only tensor"):
            g.remove_tensor_from_qubit(0, "A")
        g.lines[0][0] = ("A", 0, 2)
        with pytest.raises(ValueError, match="boundary rank"):
            g.to_dsl()
    assert ours.copy().lines == theirs.copy().lines


_SPLITS = [("mps", 6, 3, None), ("mps", 6, 3, 1), ("mps", 6, 3, 4), ("wall", 6, 3, None),
           ("wall", 5, 2, 3), ("tree", 6, 3, None), ("tree", 6, 3, 1), ("mps", 3, 2, 0),
           ("mps", 3, 2, 2)]


@pytest.mark.parametrize("kind,n,dim,idx", _SPLITS)
def test_split_and_merge_match_jax(kind, n, dim, idx):
    src = example_graph(n, kind, dim)
    assert src == jgen.example_graph(n, kind, dim)
    got, want = _outcome(lambda: split_graph(src, idx)), _outcome(lambda: j_split(src, idx))
    assert got == want
    if got[0] == "error":
        return
    left, right = got[1]
    merged, want_merged = merge_graphs(left, right), j_merge(left, right)
    assert merged == want_merged
    # merging in the other order, and a circuit with itself
    assert merge_graphs(right, left) == j_merge(right, left)
    assert merge_graphs(src, src) == j_merge(src, src)


def _fields(g):
    def edges(es):
        return [(e.qubit, e.rank, e.neighbor) for e in es]

    return g.nqubits, [(c.index, c.name, edges(c.in_edges), edges(c.out_edges))
                       for c in g.cores]


def test_with_bond_ranks_matches_jax():
    from tneq_tpu.graph import parse_graph as j_parse

    src = wall_graph(6, layers=4, dim=3)
    g, jg = parse_graph(src), j_parse(src)
    bonds = sorted({(min(c.index, e.neighbor), max(c.index, e.neighbor), e.qubit)
                    for c in g.cores for e in c.in_edges + c.out_edges if e.neighbor >= 0})
    assert len(bonds) > 4
    for rank_map in ({bonds[0]: 1}, {b: 1 for b in bonds[::2]}, {b: 2 for b in bonds}):
        assert _fields(with_bond_ranks(g, rank_map)) == _fields(j_with_ranks(jg, rank_map))
    with pytest.raises(ValueError, match="not internal bonds"):
        with_bond_ranks(g, {(0, 99, 0): 1})
    with pytest.raises(ValueError, match="not internal bonds"):
        j_with_ranks(jg, {(0, 99, 0): 1})


@pytest.mark.parametrize("kind", ["mps", "wall"])
def test_qctn_split_and_merge_carry_the_cores(kind):
    src = example_graph(6, kind, 2)
    rng = np.random.default_rng(0)
    cores = {c.name: rng.normal(size=c.shape).astype(np.float32)
             for c in parse_graph(src).cores}
    ours = QCTN(src, {k: torch.as_tensor(v) for k, v in cores.items()},
                dtype=torch.float32, device="cpu")
    import jax.numpy as jnp

    theirs = JQCTN(src, {k: jnp.asarray(v) for k, v in cores.items()}, dtype=jnp.float32)
    (l, r), (jl, jr) = ours.split(), theirs.split()
    for half, jhalf in ((l, jl), (r, jr)):
        assert half.graph.source == jhalf.graph.source and half.cores == jhalf.cores
        assert half.device == torch.device("cpu") and half.dtype == torch.float32
        for name in half.cores:
            assert half.params[name] is ours.params[name]
    merged, jmerged = l.merge_with(r), jl.merge_with(jr)
    assert QCTN.merge(l, r).graph.source == merged.graph.source == jmerged.graph.source
    got = params_to_numpy(merged.params)
    assert sorted(got) == sorted(jmerged.params)
    for name, v in jmerged.params.items():
        np.testing.assert_array_equal(got[name], np.asarray(v))


def test_qctn_render_without_a_source_matches_jax():
    from tneq_tpu.graph import parse_graph as j_parse

    src = wall_graph(4, layers=2, dim=2)
    g = parse_graph(src)
    bonds = {(min(c.index, e.neighbor), max(c.index, e.neighbor), e.qubit): 1
             for c in g.cores[:1] for e in c.out_edges if e.neighbor >= 0}
    ours = QCTN(with_bond_ranks(g, bonds), dtype=torch.float32, device="cpu")
    theirs = JQCTN(j_with_ranks(j_parse(src), bonds))
    assert ours._render() == theirs._render()
    assert [h.graph.source for h in ours.split()] == [h.graph.source for h in theirs.split()]


def test_merge_split_demo_runs_on_the_host(capsys):
    assert merge_split_demo.main(["--device", "cpu", "--graph-types", "mps", "tree",
                                  "wall"]) == 0
    out = capsys.readouterr().out
    assert out.count("(carried)") == 2 and "split not possible" in out
    assert "MISMATCH" not in out
