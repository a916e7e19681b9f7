"""Port parity: the native path finder, the einsum specs and the pairwise
schedules (tneq_tpu_torch.native / ops.einsum_spec / ops.pairwise vs their
tneq_tpu counterparts).

Everything here is exact: the same C++ source, built by the port into its
own directory, gives the same paths and costs, and the pure-Python builders
give the same strings.  Graphs: the wall, MPS and tree generators and the
reference's 8-qubit 5-cell brick wall (78 symbols in its core-only spec,
past the 52 latin letters).
"""

import numpy as np
import pytest

from tneq_tpu.graph import (
    build_brick_wall_incidence as j_brick,
    incidence_to_graph as j_inc,
    mps_graph as j_mps,
    parse_graph as j_parse,
    tree_graph as j_tree,
    wall_graph as j_wall,
)
from tneq_tpu.native import path as jpath
from tneq_tpu.ops import einsum_spec as jspec
from tneq_tpu.ops import pairwise as jpair
from tneq_tpu_torch.graph import (
    build_brick_wall_incidence,
    incidence_to_graph,
    mps_graph,
    parse_graph,
    tree_graph,
    wall_graph,
)
from tneq_tpu_torch.native import build as tbuild
from tneq_tpu_torch.native import path as tpath
from tneq_tpu_torch.ops import einsum_spec as tspec
from tneq_tpu_torch.ops import pairwise as tpair

GRAPHS = {
    "wall4": lambda m: m["wall"](4, 2, 2),
    "wall6": lambda m: m["wall"](6, 3, 2),
    "mps6": lambda m: m["mps"](6, 3),
    "tree5": lambda m: m["tree"](5, 2),
    "brick8x5": lambda m: m["inc"](m["brick"](8, 5, 2)),
}
_J = {"wall": j_wall, "mps": j_mps, "tree": j_tree, "brick": j_brick, "inc": j_inc}
_T = {"wall": wall_graph, "mps": mps_graph, "tree": tree_graph,
      "brick": build_brick_wall_incidence, "inc": incidence_to_graph}


def _graphs(name):
    return parse_graph(GRAPHS[name](_T)), j_parse(GRAPHS[name](_J))


def _shapes(graph, spec, batch=3):
    """Operand shapes of a spec: cores, per-qubit states and ``(B, K, K)``
    measures (as ``ops/compiler.estimate_cost`` builds them)."""
    out = []
    for kind, key in spec.operands:
        if kind in ("core", "core_conj", "target_core"):
            out.append(graph.shapes[key])
        elif kind in ("state", "state_conj"):
            out.append((graph.input_ranks[key],))
        else:
            out.append((batch, graph.output_ranks[key], graph.output_ranks[key]))
    return out


# 'auto' runs the exact DP up to 16 operands (checked against 'dp' there)
# and greedy beyond; a forced DP on a larger network takes tens of seconds
@pytest.mark.parametrize("method", ["auto", "greedy"])
@pytest.mark.parametrize("which", ["core_only", "siamese"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_paths_and_costs_match_jax(name, which, method):
    gt, gj = _graphs(name)
    if which == "core_only":
        st, sj = tspec.core_only_spec(gt), jspec.core_only_spec(gj)
    else:
        st, sj = tspec.siamese_spec(gt), jspec.siamese_spec(gj)
    assert st.equation == sj.equation
    shapes = _shapes(gt, st)
    assert tpath.parse_equation(st.equation, shapes) == jpath.parse_equation(sj.equation, shapes)
    path = tpath.find_path(st.equation, shapes, method)
    assert path == jpath.find_path(sj.equation, shapes, method)
    assert len(path) == len(shapes) - 1
    if method == "auto" and len(shapes) <= tpath.DP_MAX_OPERANDS:
        assert path == tpath.find_path(st.equation, shapes, "dp")
    assert tpath.path_cost(st.equation, shapes) == jpath.path_cost(sj.equation, shapes)
    # the path resolves into two-operand steps exactly as JAX's executor does
    assert tpair.pairwise_steps(st.equation, path) == jpair.pairwise_steps(sj.equation, path)


def test_trivial_paths_and_errors():
    assert tpath.find_path("ab->ba", [(2, 3)]) == jpath.find_path("ab->ba", [(2, 3)]) == [(0,)]
    assert tpath.path_cost("ab->ba", [(2, 3)]) == 0.0
    assert tpath.DP_MAX_OPERANDS == jpath.DP_MAX_OPERANDS == 16
    with pytest.raises(ValueError, match="operands"):
        tpath.parse_equation("ab,bc->ac", [(2, 3)])
    with pytest.raises(ValueError, match="inconsistent"):
        tpath.parse_equation("ab,bc->ac", [(2, 3), (4, 5)])
    with pytest.raises(ValueError, match="unknown method"):
        tpath.find_path("ab,bc->ac", [(2, 3), (3, 4)], "bogus")


def test_linear_path_matches_jax():
    for n in range(6):
        assert tpair._linear_path(n) == jpair._linear_path(n)
    eq = "ab,bc,cd,de->ae"
    assert (tpair.pairwise_steps(eq, tpair._linear_path(4))
            == jpair.pairwise_steps(eq, jpair._linear_path(4)))
    with pytest.raises(ValueError, match="itself"):
        tpair.pairwise_steps(eq, [(1, 1)])


def test_build_goes_to_the_ports_own_directory():
    lib = tbuild.build()
    assert lib.parent == tbuild.BUILD_DIR
    assert tbuild.BUILD_DIR.parts[-2:] == ("tneq_tpu_torch", "_build")
    assert lib.name.startswith("libpathfinder-") and lib.exists()


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No silent fallback: a compiler that fails, or is missing, raises."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    bad = tmp_path / "bad-cxx"
    bad.write_text("#!/bin/sh\necho 'pathfinder.cpp: error: no compiler here' >&2\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="rc 3(.|\n)*no compiler here"):
        tbuild.build(str(bad))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        tbuild.build(str(tmp_path / "missing-cxx"))
    assert list(tmp_path.glob("*.so")) == []


# ---------------------------------------------------------------------------
# einsum specs: identical fields from every builder
# ---------------------------------------------------------------------------


def _spec_pairs(gt, gj):
    yield tspec.core_only_spec(gt), jspec.core_only_spec(gj)
    yield tspec.core_only_spec(gt, "qubit"), jspec.core_only_spec(gj, "qubit")
    for batched in (True, False):
        yield tspec.with_inputs_spec(gt, batched), jspec.with_inputs_spec(gj, batched)
    for kw in ({}, {"with_states": False}, {"states_batched": True},
               {"measure_extra_dims": 2}, {"measure_extra_dims": 0}):
        yield tspec.siamese_spec(gt, **kw), jspec.siamese_spec(gj, **kw)
    for q in (0, gt.nqubits - 1):
        yield tspec.siamese_env_spec(gt, q), jspec.siamese_env_spec(gj, q)
        yield (tspec.siamese_env_spec(gt, q, states_batched=True),
               jspec.siamese_env_spec(gj, q, states_batched=True))
    yield tspec.two_network_spec(gt, gt), jspec.two_network_spec(gj, gj)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_every_builder_gives_the_same_spec(name):
    gt, gj = _graphs(name)
    for st, sj in _spec_pairs(gt, gj):
        assert (st.equation, st.operands, st.output_shape_hint, st.n_operands) == (
            sj.equation, sj.operands, sj.output_shape_hint, sj.n_operands)
    assert tspec.siamese_bond_symbols(gt) == jspec.siamese_bond_symbols(gj)
    bonds = tuple(list(tspec.siamese_bond_symbols(gt))[:2])
    st, at, rt = tspec.siamese_spec_sliced(gt, bonds)
    sj, aj, rj = jspec.siamese_spec_sliced(gj, bonds)
    assert (st.equation, st.operands, at, rt) == (sj.equation, sj.operands, aj, rj)
    st, at, rt = tspec.two_network_spec_sliced(gt, gt, bonds)
    sj, aj, rj = jspec.two_network_spec_sliced(gj, gj, bonds)
    assert (st.equation, st.operands, at, rt) == (sj.equation, sj.operands, aj, rj)


def test_brick_wall_spec_leaves_the_latin_letters():
    gt, _ = _graphs("brick8x5")
    eq = tspec.core_only_spec(gt).equation
    assert len(set(eq) - set(",->")) == 78
    assert len(set(tspec.siamese_spec(gt).equation) - set(",->")) == 157
    assert not set(eq) - set(",->") <= set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    with pytest.raises(ValueError, match="out of range"):
        tspec.siamese_env_spec(gt, 8)
    with pytest.raises(ValueError, match="internal bond"):
        tspec.siamese_spec_sliced(gt, ((0, 99, 0),))
    assert np.array_equal(build_brick_wall_incidence(8, 5), j_brick(8, 5))
