"""The launch plan of the cluster sweep kernels B1/B2
(``tneq_tpu_torch.ops.chain_overlap.sweep_plan``), on the CPU.

The kernels of ``csrc/chain_sweep.cu`` run only on the card; every decision
their shape depends on (cluster size, strips, ring depth, tile rows, shared
memory) is made here in Python, so these tests reach all of it.  The source
is also read as text, to hold the constants and C signatures the wrapper
relies on to what the kernels declare.
"""

import ctypes
import re
from pathlib import Path

import pytest

from tneq_tpu_torch.ops import chain_overlap as co

SOURCE = (Path(co.__file__).resolve().parent.parent / "csrc" / "chain_sweep.cu").read_text()
SIZES = [1, 4, 9, 130, 256, 576, 1024]
SITES = [1, 3, 29]


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n", SITES)
@pytest.mark.parametrize("S", SIZES)
def test_plan_fits_the_card(S, n, backward):
    for max_cluster in (co.MAX_CLUSTER, co.PORTABLE_CLUSTER):
        cluster, strip, stages, tile_rows, smem = co.sweep_plan(n, S, backward, max_cluster)
        # the strips tile S exactly: no CTA empty, no gap, no overlap
        strips = [(c * strip, min((c + 1) * strip, S)) for c in range(cluster)]
        assert all(lo < hi for lo, hi in strips)
        assert strips[0][0] == 0 and strips[-1][1] == S
        assert all(a[1] == b[0] for a, b in zip(strips, strips[1:]))
        assert 1 <= cluster <= min(max_cluster, 16)
        assert smem <= 232448
        # a ring tile is rows of the CTA's share: strip columns (B1) or S (B2)
        row, rows_per_site = (S, strip) if backward else (co.tile_pitch(strip), S)
        assert 1 <= tile_rows <= rows_per_site
        assert 4 * stages * tile_rows * row < smem
        # the ring never holds more sites than there are, and holds two
        # tiles wherever the chain has two
        tiles = n * _ceil(rows_per_site, tile_rows)
        assert min(2, tiles) <= stages <= min(co.MAX_STAGES, tiles)
        if S % 4 == 0:  # 16-byte copies: strips start on 16-byte boundaries
            assert strip % 4 == 0
        assert strip <= 128  # B1: 4 column quads per warp; B2: a row per thread


@pytest.mark.parametrize("backward", [False, True])
def test_plan_at_the_main_shapes(backward):
    # the bench shape: 16 CTAs of 16 columns/rows, one whole site per tile
    cluster, strip, stages, tile_rows, _ = co.sweep_plan(29, 256, backward)
    assert (cluster, strip) == (16, 16)
    assert tile_rows == (16 if backward else 256)
    assert stages >= 8  # prefetches a third of the chain or more
    # S = 1024: a site's share (256 KiB) outgrows the CTA; the ring holds two
    # of three balanced row tiles
    cluster, strip, stages, tile_rows, _ = co.sweep_plan(29, 1024, backward)
    assert (cluster, strip) == (16, 64)
    rows_per_site = 64 if backward else 1024
    assert _ceil(rows_per_site, tile_rows) == 3 and stages == 2
    # the portable limit halves the cluster
    assert co.sweep_plan(29, 1024, backward, 8)[:2] == (8, 128)
    # the smallest problem is one CTA
    assert co.sweep_plan(1, 1, backward)[:4] == (1, 1, 1, 1)


@pytest.mark.parametrize("lanes", [1, 3, 8, 16, 35])
@pytest.mark.parametrize("S", SIZES)
def test_plan_with_lanes_fits_the_card(S, lanes):
    """lanes x cluster CTAs stay within the card's 132 SMs wherever the
    strip width allows: the cluster halves until they fit or half of it
    would leave a strip wider than 128."""
    for backward in (False, True):
        plan = co.sweep_plan(29, S, backward, co.MAX_CLUSTER, lanes)
        cluster, strip = plan[:2]
        assert strip <= co.MAX_STRIP and cluster * strip >= S
        assert lanes * cluster <= co.SMS or cluster // 2 < _ceil(S, co.MAX_STRIP)
        if lanes == 1:
            assert plan == co.sweep_plan(29, S, backward)


def test_plan_with_lanes_at_the_main_shapes():
    # the batched prune's 8 lanes of the 12-qubit chain: 8 clusters of 16
    assert co.sweep_plan(10, 256, False, 16, 8)[:2] == (16, 16)
    # 16 lanes halve the cluster to 8 (128 SMs), 35 lanes to 2 (70 SMs)
    assert co.sweep_plan(10, 256, False, 16, 16)[:2] == (8, 32)
    assert co.sweep_plan(10, 256, False, 16, 35)[:2] == (2, 128)
    # S = 1024 never goes below 8 CTAs of 128 columns
    assert co.sweep_plan(10, 1024, True, 16, 35)[:2] == (8, 128)
    with pytest.raises(ValueError, match="lanes"):
        co.sweep_plan(3, 16, lanes=0)


@pytest.mark.parametrize("S", [9, 130, 1000])
def test_plan_ragged_strips(S):
    cluster, strip, *_ = co.sweep_plan(29, S)
    assert cluster * strip >= S and (cluster - 1) * strip < S


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="S <= 1024"):
        co.sweep_plan(3, 1025)
    with pytest.raises(ValueError, match="n >= 1"):
        co.sweep_plan(0, 16)
    with pytest.raises(ValueError, match="max_cluster"):
        co.sweep_plan(3, 16, max_cluster=17)


@pytest.mark.parametrize("name,value", [
    ("kThreads", co.THREADS), ("kMaxCluster", co.MAX_CLUSTER),
    ("kPortableCluster", co.PORTABLE_CLUSTER), ("kMaxStages", co.MAX_STAGES),
    ("kSmemMax", co.SMEM_MAX), ("kMaxS", co.MAX_S), ("kBarFloats", co.BAR_FLOATS),
    ("kMaxStrip", co.MAX_STRIP),
])
def test_plan_constants_match_the_source(name, value):
    m = re.search(rf"constexpr \w+ {name} = (\d+);", SOURCE)
    assert m and int(m.group(1)) == value


@pytest.mark.parametrize("fn", ["tneq_chain_sweep_fwd", "tneq_chain_sweep_bwd",
                                "tneq_chain_sweep_max_cluster"])
def test_ctypes_signatures_match_the_source(fn):
    """The argtypes ``_lib`` declares, against the C parameter list: a
    pointer for every pointer, c_size_t for size_t, c_int for int."""
    params = re.search(rf"int {fn}\(([^)]*)\)", SOURCE).group(1)
    want = []
    for p in (x.strip() for x in params.split(",")):
        if "*" in p:
            want.append("int*" if p.startswith("int*") else "ptr")
        else:
            want.append(p.split()[0])
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_size_t: "size_t",
            ctypes.POINTER(ctypes.c_int): "int*"}
    assert [kind[t] for t in co._SIGNATURES[fn]] == want


def test_tile_pitch_spreads_float4_reads_over_the_banks():
    """8 consecutive rows of one float4 column fall in 8 bank groups."""
    for strip in range(1, 129):
        P = co.tile_pitch(strip)
        assert P % 4 == 0 and strip <= P <= strip + 7
        assert len({(a * P // 4) % 8 for a in range(8)}) == 8, strip
