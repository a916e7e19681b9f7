"""Port parity: graph DSL and generators (tneq_tpu_torch.graph vs tneq_tpu.graph).

Both packages must produce identical DSL strings, identical CircuitGraph
fields and the same rendered DSL for every generator.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tneq_tpu import graph as jg
from tneq_tpu.graph.dsl import render_dsl as j_render
from tneq_tpu.ops.mps_sweep import is_mps_chain as j_is_chain
from tneq_tpu_torch import graph as tg
from tneq_tpu_torch.graph.dsl import render_dsl as t_render
from tneq_tpu_torch.graph.generators import TARGET_EXAMPLE as T_TARGET
from tneq_tpu.graph.generators import TARGET_EXAMPLE as J_TARGET
from tneq_tpu_torch.ops.mps_sweep import is_mps_chain as t_is_chain

torch.set_num_threads(1)

GENERATORS = [
    ("mps_graph", (6,), {"dim": 3}),
    ("mps_graph", (8,), {"dim": 4, "phys": 2}),
    ("mps_graph", (2,), {"dim": 2}),
    ("tree_graph", (7,), {"dim": 2}),
    ("tree_graph", (8,), {"dim": 3}),
    ("wall_graph", (6,), {"layers": 4, "dim": 2}),
    ("wall_graph_col", (5,), {"layers": 3, "dim": 2}),
    ("example_graph", (6,), {"graph_type": "tree"}),
    ("example_graph", (6,), {"graph_type": "wall"}),
    ("example_graph", (5,), {"target": True}),
]


def _fields(g):
    return (
        g.nqubits,
        [dataclasses.astuple(c) for c in g.cores],
        g.signature,
        g.core_names,
        g.input_ranks,
        g.output_ranks,
        g.shapes,
        [g.qubit_cores(q) for q in range(g.nqubits)],
    )


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{n}{a}{sorted(k.items())}" for n, a, k in GENERATORS])
def test_generator_parity(name, args, kw):
    s_j = getattr(jg, name)(*args, **kw)
    s_t = getattr(tg, name)(*args, **kw)
    assert s_t == s_j
    g_j, g_t = jg.parse_graph(s_j), tg.parse_graph(s_t)
    assert _fields(g_t) == _fields(g_j)
    assert t_render(g_t) == j_render(g_j)
    assert t_is_chain(g_t) == j_is_chain(g_j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_graph_parity(seed):
    s_j = jg.random_graph(5, 3, rng=np.random.default_rng(seed))
    s_t = tg.random_graph(5, 3, rng=np.random.default_rng(seed))
    assert s_t == s_j
    assert _fields(tg.parse_graph(s_t)) == _fields(jg.parse_graph(s_j))


@pytest.mark.parametrize("n_qubits,n_cells,rank", [(4, 2, 2), (6, 3, 2), (5, 2, 3)])
def test_incidence_parity(n_qubits, n_cells, rank):
    inc_j = jg.build_brick_wall_incidence(n_qubits, n_cells, rank)
    inc_t = tg.build_brick_wall_incidence(n_qubits, n_cells, rank)
    np.testing.assert_array_equal(inc_t, inc_j)
    for kw in ({}, {"mask_list": [0, 2], "for_display": True}):
        assert tg.incidence_to_graph(inc_t, **kw) == jg.incidence_to_graph(inc_j, **kw)
    s = tg.incidence_to_graph(inc_t)
    assert _fields(tg.parse_graph(s)) == _fields(jg.parse_graph(s))


def test_target_example_and_symbols():
    assert T_TARGET == J_TARGET
    g_t, g_j = tg.parse_graph(T_TARGET), jg.parse_graph(J_TARGET)
    assert _fields(g_t) == _fields(g_j)
    assert [tg.get_symbol(i) for i in range(60)] == [jg.get_symbol(i) for i in range(60)]


def test_render_roundtrip_and_errors():
    g = tg.parse_graph(tg.mps_graph(5, dim=3, phys=2))
    assert tg.parse_graph(t_render(g)) == g
    with pytest.raises(ValueError):
        tg.parse_graph("---")
    with pytest.raises(ValueError):
        tg.mps_graph(1)
