"""The launch shape of the per-thread-sum backwards (the stock and tilt
builds of merit_bwd and trace_bwd): ``launch.bwd_shape`` picks the block
from the shared memory each thread needs, ``launch.bwd_grid`` the grid.
These run without a card; the kernels' own checks are in
``tests/test_torch_cuda.py``."""

import pytest
import torch

from optiland_torch.ops import launch
from optiland_torch.ops.step import FULL_GRAD_COLS, GRAD_COLS

MODES = ("merit", "field", "generic", "poly")


def _shared_bytes(S, nm, mode, dtype, block):
    """A block's columns, counted from the kernels' layout
    (csrc/fused_trace.cuh, csrc/fast_trace.cuh, store_pt_row): each
    thread's slots of surfaces 1 .. S-1, the object row's n_post slot and
    the aim entries, and each warp's row of dispersion columns."""
    size = torch.finfo(dtype).bits // 8
    slots = len(GRAD_COLS) if mode == "merit" else len(FULL_GRAD_COLS)
    aim = launch.N_AIM if mode in ("merit", "field") else 0
    row = S * nm if mode == "poly" else 0
    return (block * ((S - 1) * slots + 1 + aim) + block // 32 * row) * size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_bwd_shape_fits_every_stock_and_tilt_system(mode, dtype):
    room = launch.SMEM_MAX - launch.SMEM_STATIC
    for S in range(2, launch.STOCK_SURF + 1):
        for nm in range(1, 21):
            for want in range(32, launch.BWD_BLOCK + 1, 32):
                block, dyn = launch.bwd_shape(S, nm, mode, dtype, want)
                assert block % 32 == 0 and 32 <= block <= want
                assert dyn == _shared_bytes(S, nm, mode, dtype, block)
                assert dyn <= room <= launch.SMEM_MAX
                # the largest block that fits
                assert block == want or _shared_bytes(
                    S, nm, mode, dtype, block + 32) > room


def test_bwd_shape_of_the_cooke_triplet_and_the_widest_system():
    # the Cooke triplet (8 surfaces) takes the full block in f32
    assert launch.bwd_shape(8, 0, "merit", torch.float32) == (
        128, 128 * (7 * 9 + 1 + 8) * 4)
    assert launch.bwd_shape(8, 0, "field", torch.float32) == (
        128, 128 * (7 * 10 + 1 + 8) * 4)
    assert launch.bwd_shape(8, 20, "poly", torch.float32) == (
        128, (128 * (7 * 10 + 1) + 4 * 8 * 20) * 4)
    # the widest system the stock and tilt builds take, 16 surfaces and 20
    # dispersion coefficients in f64: 151 columns per thread and 320 per
    # warp still fit 128 threads
    assert launch.bwd_shape(16, 20, "poly", torch.float64) == (
        128, (128 * 151 + 4 * 320) * 8)
    # where they would not, the block shrinks: 64 surfaces take 32 threads
    assert launch.bwd_shape(64, 20, "poly", torch.float64) == (
        32, (32 * 631 + 1280) * 8)
    # the request bounds the block whatever fits
    assert launch.bwd_shape(8, 0, "generic", torch.float32, 64)[0] == 64


@pytest.mark.parametrize("block", [0, 16, 48, 100, 160, 256])
def test_bwd_shape_refuses_blocks_that_are_not_a_multiple_of_32(block):
    with pytest.raises(ValueError, match="multiple of 32"):
        launch.bwd_shape(8, 0, "merit", torch.float32, block)


def test_only_the_stock_and_tilt_builds_sum_per_thread():
    assert [b for b in launch.BUILD_SUFFIX if launch.per_thread(b)] == [
        launch.STOCK, launch.TILT]
    # the grating build keeps its grid of BWD_MAX_BLOCKS x BWD_BLOCK threads
    # and its per-warp rows (no card needed to say so); the Newton builds
    # (below) and nurbs take one wave of blocks from their occupancy
    for build in (launch.GRAT,):
        for block in (32, 64, 128):
            assert launch.bwd_grid("trace_bwd", "generic", 8, 0,
                                   torch.float32, build, 1 << 24, "cpu",
                                   block) == (
                block, launch.BWD_MAX_BLOCKS * (launch.BWD_BLOCK // block), 0)
        assert launch.bwd_grid("merit_bwd", "merit", 8, 0, torch.float32,
                               build, 1000, "cpu") == (128, 8, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_builds_size_their_per_warp_rows(dtype):
    # the per-warp rows of ncomp columns: static in the sag build (no
    # dynamic bytes), dynamic in the Cartesian and deep ones
    size = torch.finfo(dtype).bits // 8
    newton = (launch.SAG, launch.FREE, launch.AUX, launch.DEEP,
              launch.DEEP_FREE, launch.DEEP_AUX)
    assert {b for b in launch.BUILD_SUFFIX if b & launch.BIT_SAG} == set(
        newton)
    for build in newton:
        for block, ncomp in ((32, 7), (64, 100), (128, 700)):
            want = 0 if build == launch.SAG else block // 32 * ncomp * size
            assert launch.newton_bwd_bytes(block, ncomp, build,
                                           dtype) == want, build


def _nurbs_bytes(block, ncomp, ns, nc, kt, dtype):
    """A nurbs-build backward's shared memory, counted from the kernels'
    layout (csrc/nurbs_step.cuh: nurbs_bwd_bytes, nurbs_tables,
    nurbs_own_cols; csrc/fused_trace.cuh, csrc/fast_trace.cuh): each
    warp's row of ncomp columns, rounded up to a 4-vector, the kt rows of
    the knot table (NU_KT wide, the surfaces' and the tail's), the ns NURBS
    surfaces' homogeneous nets of nc columns (each rounded up to a
    4-vector), then each lane's staged record, two points of NU_PT values
    (12 net cotangents, then the 1-D basis values and derivatives in u and
    v, NU_PMAX + 1 each) and four int spans."""
    size = torch.finfo(dtype).bits // 8
    per_point = 12 + 4 * (launch.NU_PMAX + 1)
    rows = -(-(block // 32 * ncomp) // 4) * 4
    return ((rows + kt * launch.NU_KT + ns * (-(-nc // 4) * 4)
             + block * 2 * per_point) * size + block * 4 * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nurbs_shape_fits_or_refuses(dtype):
    """The nurbs build's block: the largest multiple of 32 up to the
    request whose rows, tables and staged records fit, for every system
    the build takes (up to STOCK_SURF surfaces, NC_NURBS net columns, a
    knot table with a tail of 1 to 5 rows); where 32 threads would not fit
    (wider than the build takes), NotImplementedError: the launch does not
    fall back."""
    room = launch.SMEM_MAX - launch.SMEM_STATIC
    for S in (2, 4, 9, launch.STOCK_SURF):
        for nsag in range(1, S):
            for nc in (16, 99, 196, launch.NC_NURBS):
                ncomp = S * len(FULL_GRAD_COLS) + nsag * nc + launch.N_AIM
                kt = S + 1 + nsag % 5
                for want in (32, 64, 128):
                    block, dyn = launch.nurbs_shape(nsag, nc, kt, ncomp,
                                                    dtype, want)
                    assert block % 32 == 0 and 32 <= block <= want
                    assert dyn == _nurbs_bytes(block, ncomp, nsag, nc, kt,
                                               dtype) <= room
                    assert block == want or _nurbs_bytes(
                        block + 32, ncomp, nsag, nc, kt, dtype) > room
    wide = 40 * launch.NC_NURBS
    with pytest.raises(NotImplementedError, match="shared memory"):
        launch.nurbs_shape(launch.STOCK_SURF - 1, wide, launch.STOCK_SURF + 9,
                           15 * wide, dtype)


def test_nurbs_shape_of_the_golden_lenses():
    """The golden NURBS lenses (4 surfaces, one 7 x 7 net: nc = 196; a knot
    table of 4 + 2 rows) take the full block in both types, and a second
    NURBS surface adds only its columns to the rows and its net to the
    tables: the warps' records are staged one surface at a time."""
    ncomp = 4 * len(GRAD_COLS) + 196 + launch.N_AIM
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        assert launch.nurbs_shape(1, 196, 6, ncomp, dtype) == (
            128, (4 * ncomp + 6 * launch.NU_KT + 196 + 128 * 88) * size
            + 128 * 16)
        assert launch.nurbs_shape(2, 196, 7, ncomp + 196, dtype) == (
            128, _nurbs_bytes(128, ncomp + 196, 2, 196, 7, dtype))


def test_nurbs_bytes_count_the_knot_table_tail():
    """The nurbs build's tables in shared memory, from the knot tables the
    kernels get (launch.kernel_tables: the surfaces' rows, then the tail
    of E, ns, offsets, net slots and reciprocal knot differences): the
    golden rational lens (a 7 x 7 net of degree 3: 2 tail rows) and the
    net at the build's bounds (16 x 4, degree 7 on 24 knots: 4 rows), the
    forward's room for a net on every surface, a backward's for its NURBS
    surfaces only."""
    from optiland_torch import config
    from optiland_torch.samples import nurbs

    prev = config.get_device()
    config.set_device("cpu")
    try:
        systems = [(nurbs.rational_nurbs().system, 196, 6),
                   (nurbs.bound_nurbs().system, 256, 8)]
    finally:
        config.set_device(prev)
    for system, nc, kt in systems:
        coeffs, lay = launch.kernel_tables(system, torch.float64)
        assert coeffs.shape[1] == nc and launch.knot_rows(lay) == kt
        tail = lay[4:].reshape(-1)
        n_rc = sum(p * (n + p + 1) for n, p in ((system.cfg.geom_aux[1][1],
                                                 system.cfg.geom_aux[1][3]),
                                                (system.cfg.geom_aux[1][2],
                                                 system.cfg.geom_aux[1][4])))
        assert int(tail[0]) == kt - 4 == -(-(2 + 2 * 4 + n_rc)
                                          // launch.NU_KT)
        assert int(tail[1]) == 1
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            assert launch.nurbs_bytes(4, nc, kt, dtype) == (
                kt * launch.NU_KT + 4 * nc) * size
            ncomp = 4 * len(GRAD_COLS) + nc + launch.N_AIM
            assert launch.nurbs_bwd_bytes(128, ncomp, 1, nc, kt, dtype) == (
                (4 * ncomp + kt * launch.NU_KT + nc + 128 * 88) * size
                + 128 * 16)
    # one row's width not a multiple of 4: the nets start on a 4-vector
    assert launch.nurbs_bytes(3, 13, 5, torch.float32) == (
        5 * launch.NU_KT + 3 * 16) * 4
    assert launch.nurbs_bwd_bytes(32, 7, 1, 13, 5, torch.float32) == (
        8 + 5 * launch.NU_KT + 16 + 32 * 88) * 4 + 32 * 16
