"""The two passes of the CSR blend backward B4 in their plain versions:
csr_bwd_walk_plain(csr_bwd_pieces_plain(...)) against the sequential twin
(blend_csr_bwd_plain) and against jax.vjp of the JAX package's Pallas CSR
blend run in interpret mode, on CSR streams with empty tiles, one- and
multi-segment tiles, tiles that saturate inside a walked segment, a run
ending in padding rows, and padding segments; the skip decided per 256-row
segment, not per 64-row piece; and each tile's carry on its own.

Tolerances. The split sums the log prefix and the suffix carry piece by
piece, the twin over the whole segment, so the two agree to their float32
rounding: 1e-5 of each gradient column's largest value. Against Pallas,
test_csr_bwd_twin_matches_pallas_vjp's 1e-4 relative and 1e-4 of the
largest gradient (sums over 256 pixels and up to 1,024 rows, cumsum
against Hillis-Steele). The comparisons run on one thread: a CPU sum split
across threads can round differently from call to call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_pallas import blend_csr as jax_blend_csr
from activesplat_tpu_torch.ops import raster_cuda as rc

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

TILES_X, TILES_Y = 4, 3
N_TILES = TILES_X * TILES_Y
PAD_ROW = np.array([-1e9, -1e9, 1.0, 1.0, 1.0] + [0.0] * 11, np.float32)
# segments per tile: none, one, several (up to four), saturating runs
SEGMENTS = [1, 3, 0, 2, 1, 0, 4, 1, 2, 0, 1, 2]
OPAQUE = 3  # wide, opaque Gaussians: saturates within a few rows of its first segment
GRADUAL = 8  # saturates inside its first segment; its second is skipped
PADDED = 7  # 40 members, padded to CSEG
N_PAD_SEGMENTS = 2  # trailing segments keyed to the padding tile N_TILES
REL_TOL = 1e-5


def make_stream(rng, c):
    """(entry_data (E, 16), seg_tile, seg_u0, seg_v0) with every tile's run
    CSEG-aligned and N_PAD_SEGMENTS padding segments at the end."""
    rows, seg_tile = [], []
    for tile, n_seg in enumerate(SEGMENTS + [N_PAD_SEGMENTS]):
        u0, v0 = (tile % TILES_X) * rc.TILE, (tile // TILES_X) * rc.TILE
        n = n_seg * rc.CSEG
        r = np.zeros((n, rc.N_ATTR), np.float32)
        r[:, 0] = u0 + rng.uniform(-6, 22, n)
        r[:, 1] = v0 + rng.uniform(-6, 22, n)
        r[:, 2] = rng.uniform(0.05, 0.6, n)
        r[:, 3] = rng.uniform(-0.05, 0.05, n)
        r[:, 4] = rng.uniform(0.05, 0.6, n)
        r[:, 5] = rng.uniform(0.01, 0.08, n)
        r[:, 6 : 6 + c] = rng.uniform(0, 1, (n, c))
        if tile in (OPAQUE, GRADUAL):
            r[:, 2] = rng.uniform(0.001, 0.004, n)
            r[:, 3] = 0.0
            r[:, 4] = rng.uniform(0.001, 0.004, n)
            r[:, 5] = 0.95 if tile == OPAQUE else rng.uniform(0.03, 0.05, n)
        if tile == PADDED:
            r[40:] = PAD_ROW
        if tile == N_TILES:
            r[:] = PAD_ROW
        rows.append(r)
        seg_tile += [tile] * n_seg
    seg_tile = np.array(seg_tile, np.int32)
    in_grid = seg_tile < N_TILES
    seg_u0 = np.where(in_grid, seg_tile % TILES_X * rc.TILE, 0).astype(np.int32)
    seg_v0 = np.where(in_grid, seg_tile // TILES_X * rc.TILE, 0).astype(np.int32)
    return np.concatenate(rows), seg_tile, seg_u0, seg_v0


def backward_inputs(seed, c):
    """A stream, its forward stash from the port's twin, and cotangents."""
    rng = np.random.default_rng(seed)
    stream = make_stream(rng, c)
    g_acc = rng.normal(size=(N_TILES, rc.PX, c)).astype(np.float32)
    g_lt = rng.normal(size=(N_TILES, rc.PX)).astype(np.float32)
    args = tuple(torch.from_numpy(x) for x in stream)
    _, _, entry = rc.blend_csr_fwd(*args, N_TILES, c, with_entry=True)
    return stream, args, entry, torch.from_numpy(g_acc), torch.from_numpy(g_lt)


def split(args, entry, g_acc, g_lt, c):
    """The two passes' plain versions chained: the kernels' algorithm."""
    pieces = rc.csr_bwd_pieces_plain(*args, entry, g_acc, N_TILES, c)
    return pieces, rc.csr_bwd_walk_plain(*args, entry, g_acc, g_lt, pieces, N_TILES, c)


def segment_rows(seg_tile, tile):
    """The row range of `tile`'s run."""
    first = int(np.searchsorted(seg_tile, tile)) * rc.CSEG
    return slice(first, first + SEGMENTS[tile] * rc.CSEG)


def piece_entries(entry, pieces):
    """Each piece's entry logT (n_seg, N_PIECES, PX) from its segment's stash
    and the log steps of the pieces before it."""
    steps = torch.cat([torch.zeros_like(pieces[:, :1, :, 0]), pieces[:, :-1, :, 0]], dim=1)
    return entry[:, None, :] + steps.cumsum(dim=1)


@pytest.mark.parametrize("seed", [31, 32])
@pytest.mark.parametrize("c", [3, 5])
def test_plain_split_matches_sequential_twin(c, seed):
    """The split against blend_csr_bwd_plain: every gradient column within
    1e-5 of its largest value; columns from 6 + C on exactly zero."""
    _, args, entry, g_acc, g_lt = backward_inputs(seed, c)
    pieces, got = split(args, entry, g_acc, g_lt, c)
    assert pieces.shape == (len(args[1]), rc.N_PIECES, rc.PX, 2)
    want = rc.blend_csr_bwd_plain(*args, entry, g_acc, g_lt, N_TILES, c)
    col_max = want.abs().amax(dim=0)
    assert bool(((got - want).abs() <= REL_TOL * col_max).all())
    assert bool((got[:, 6 + c :] == 0).all())
    assert bool((col_max[: 6 + c] > 0).all())


def test_plain_split_matches_pallas_vjp():
    """The split against jax.vjp of the Pallas CSR blend (interpret mode)."""
    c = 5
    stream, args, _, g_acc, g_lt = backward_inputs(33, c)
    maps = tuple(jnp.asarray(x) for x in stream[1:])
    _, vjp = jax.vjp(
        lambda d: jax_blend_csr(d, *maps, N_TILES, c, True), jnp.asarray(stream[0])
    )
    (ref,) = vjp((jnp.asarray(g_acc.numpy()), jnp.asarray(g_lt.numpy())))
    ref = np.asarray(ref)
    _, _, entry = rc.blend_csr_fwd(*args, N_TILES, c, with_entry=True)
    in_grid = stream[1] < N_TILES
    seg_max = entry.numpy()[in_grid].max(axis=1)
    # both sides decide the skip on max logT < LOG_EPS: keep clear of it
    assert np.all(np.abs(seg_max - rc.LOG_EPS) > 0.05), seg_max
    got = split(args, entry, g_acc, g_lt, c)[1].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_skipped_and_padding_segments_get_exact_zeros():
    """The saturating tiles' second segments were skipped by the forward and
    the padding segments belong to no tile: their piece totals and gradient
    rows are exactly zero; the walked segments' are not."""
    c = 5
    stream, args, entry, g_acc, g_lt = backward_inputs(34, c)
    pieces, d_rows = split(args, entry, g_acc, g_lt, c)
    walked = rc._csr_walked(entry, args[1], N_TILES)
    n_seg = len(stream[1])
    padding = torch.from_numpy(stream[1] >= N_TILES)
    for tile in (OPAQUE, GRADUAL):
        first = int(np.searchsorted(stream[1], tile))
        assert bool(walked[first]) and not bool(walked[first + 1])
    assert bool(padding.any()) and not bool(walked[padding].any())
    assert bool((pieces[~walked] == 0).all())
    assert bool((d_rows.view(n_seg, -1)[~walked] == 0).all())
    assert bool((d_rows.view(n_seg, -1)[walked] != 0).any(dim=1).all())


def test_walked_segment_walks_pieces_entering_below_log_eps():
    """The skip is the segment's: in the gradually saturating tile's walked
    first segment the later pieces enter below LOG_EPS at every pixel, yet
    their gradient rows are not zero and agree with the sequential twin.
    Rows skipped by each piece's own entry logT would be zeros there."""
    c = 5
    stream, args, entry, g_acc, g_lt = backward_inputs(35, c)
    pieces, d_rows = split(args, entry, g_acc, g_lt, c)
    first = int(np.searchsorted(stream[1], GRADUAL))
    e = piece_entries(entry, pieces)[first]  # (N_PIECES, PX)
    assert float(entry[first].max()) >= rc.LOG_EPS
    assert float(e[-1].max()) < rc.LOG_EPS  # the last piece enters below LOG_EPS
    want = rc.blend_csr_bwd_plain(*args, entry, g_acc, g_lt, N_TILES, c)
    last = slice(first * rc.CSEG + (rc.N_PIECES - 1) * rc.SEG, (first + 1) * rc.CSEG)
    assert float(d_rows[last].abs().max()) > 0
    col_max = want.abs().amax(dim=0)
    assert bool(((d_rows[last] - want[last]).abs() <= REL_TOL * col_max).all())
    # zero rows there would miss the tolerance: the rows carry real gradient
    assert bool((want[last].abs() > 10 * REL_TOL * col_max).any())


def test_each_tile_carry_is_its_own():
    """Changing one multi-segment tile's rows (and with them its own stash)
    leaves every other tile's gradient rows bitwise as they were: each
    tile's fold starts at its own last segment."""
    c = 5
    stream, args, entry, g_acc, g_lt = backward_inputs(36, c)
    _, before = split(args, entry, g_acc, g_lt, c)
    tile = 6  # four segments
    rows = segment_rows(stream[1], tile)
    data = args[0].clone()
    data[rows, 5] = data[rows, 5] * 1.5
    data[rows, 6 : 6 + c] = data[rows, 6 : 6 + c].flip(0)
    changed = (data, *args[1:])
    _, _, entry2 = rc.blend_csr_fwd(*changed, N_TILES, c, with_entry=True)
    mine = torch.from_numpy(stream[1] == tile)
    assert torch.equal(entry2[~mine], entry[~mine])
    _, after = split(changed, entry2, g_acc, g_lt, c)
    others = torch.ones(len(data), dtype=torch.bool)
    others[rows] = False
    assert not torch.equal(after[rows], before[rows])
    assert torch.equal(after[others], before[others])


def test_pass_wrappers_check_their_inputs():
    """The pass wrappers check shapes before they touch the card."""
    c = 5
    _, args, entry, g_acc, g_lt = backward_inputs(37, c)
    pieces = rc.csr_bwd_pieces_plain(*args, entry, g_acc, N_TILES, c)
    with pytest.raises(ValueError):
        rc.csr_bwd_walk_cuda(*args, entry, g_acc, g_lt, pieces[:, :2], N_TILES, c)
    with pytest.raises(ValueError):
        rc.csr_bwd_walk_cuda(*args, entry, g_acc[:, :, :3], g_lt, pieces, N_TILES, c)
    with pytest.raises(ValueError):
        rc.csr_bwd_pieces_cuda(*args, entry[:-1], g_acc, N_TILES, c)
    with pytest.raises(ValueError):  # CPU tensors: the kernels take CUDA ones only
        rc.csr_bwd_pieces_cuda(*args, entry, g_acc, N_TILES, c)
