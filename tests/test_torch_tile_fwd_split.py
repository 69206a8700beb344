"""The two passes of the tile-blend forward B1 in their plain versions:
tile_fwd_combine_plain(tile_fwd_partials_plain(...)) against the sequential
twin (blend_tiles_fwd_plain) and against the JAX package's Pallas blend run
in interpret mode, on test_torch_kernels' rows at K=128 and K=256 (two and
four 64-row segments); a saturating tile's later partials, which the
combine never reads; and a model, in torch, of pass 1's rank-major block
numbering and of its exact skip under any schedule.

Tolerances. The split sums the same float32 log steps in the same order as
the sequential twin, so logT and the stash are compared bitwise; only
accum is reassociated (exp(logT) * sum in place of sum exp(excl + logT)):
1e-5 of each channel's largest value. Against Pallas, test_torch_kernels'
1e-5 relative and 1e-4 absolute (cumsum against Hillis-Steele)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_pallas import _blend_fwd_pallas, blend_tiles_pallas
from activesplat_tpu_torch.ops import raster_cuda as rc
from tests.test_torch_kernels import C, T, assert_clear_of_eps
from tests.test_torch_tile_bwd_split import make_rows

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def rows_at(seed, case, k):
    return tuple(torch.from_numpy(x) for x in make_rows(np.random.default_rng(seed), case, k))


def split(rows, u0, v0, with_entry=True, partials=None):
    """The two passes' plain versions chained: the kernels' algorithm."""
    if partials is None:
        partials = rc.tile_fwd_partials_plain(rows, u0, v0, C)
    return rc.tile_fwd_combine_plain(partials, C, with_entry)


def assert_accum_close(got, want):
    limit = 1e-5 * want.abs().amax(dim=(0, 1))  # of each channel's largest value
    assert bool(((got - want).abs() <= limit).all()), float((got - want).abs().max())


@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("case", ["plain", "edge"])
def test_plain_split_is_the_sequential_twin(case, k):
    """Per pixel, each segment's log step is the twin's in-segment sum and
    the combine adds the steps in the twin's order, so logT and the stash
    are blend_tiles_fwd_plain's bit for bit; the image is reassociated."""
    rows, u0, v0 = rows_at(41, case, k)
    partials = rc.tile_fwd_partials_plain(rows, u0, v0, C)
    assert partials.shape == (T, k // rc.SEG, rc.PX, C + 1)
    accum, logt, entry = split(rows, u0, v0, partials=partials)
    accum_t, logt_t, entry_t = rc.blend_tiles_fwd_plain(rows, u0, v0, C, with_entry=True)
    assert torch.equal(logt, logt_t) and torch.equal(entry, entry_t)
    assert_accum_close(accum, accum_t)
    acc_n, logt_n = split(rows, u0, v0, with_entry=False, partials=partials)
    assert torch.equal(acc_n, accum) and torch.equal(logt_n, logt)


@pytest.mark.parametrize("case", ["plain", "edge"])
def test_plain_split_matches_pallas(case):
    """The split against the Pallas blend (interpret mode) at K=256, four
    segments: the image and logT of blend_tiles_pallas, and the stash of
    _blend_fwd_pallas with its entry output."""
    rows, u0, v0 = rows_at(42, case, 256)
    args = tuple(jnp.asarray(x.numpy()) for x in (rows, u0, v0))
    accum, logt, entry = split(rows, u0, v0)
    assert_clear_of_eps(entry.numpy())
    ref = blend_tiles_pallas(*args, n_channels=C, interpret=True)
    ref_entry = _blend_fwd_pallas(*args, n_channels=C, interpret=True, with_entry=True)[2]
    for got, want in zip((accum, logt, entry), (*ref, ref_entry)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    if case == "edge":
        assert float(logt[2].max()) < rc.LOG_EPS  # tile 2 saturated
        assert bool((accum[3] == 0).all()) and bool((logt[3] == 0).all())  # tile 3 empty


@pytest.mark.parametrize("fill", [float("nan"), 1e30, -1e30])
def test_saturated_tile_never_reads_later_partials(fill):
    """Tile 2 of the edge rows saturates in its first segment: whatever its
    later segments' partials hold (pass 1 skips them and writes nothing),
    the combine's outputs are unchanged, bit for bit."""
    rows, u0, v0 = rows_at(43, "edge", 256)
    partials = rc.tile_fwd_partials_plain(rows, u0, v0, C)
    assert float(partials[2, 0, :, C].max()) < rc.LOG_EPS  # its first step saturates it
    junk = partials.clone()
    junk[2, 1:] = fill
    for a, b in zip(split(rows, u0, v0, partials=junk), split(rows, u0, v0, partials=partials)):
        assert torch.equal(a, b)


def block_map(n_tiles, n_seg):
    """tile_fwd_partials_kernel's numbering: block b takes segment b // T of
    tile b % T. Returns (tile, segment) per block, in launch order."""
    b = torch.arange(n_tiles * n_seg)
    return b % n_tiles, torch.div(b, n_tiles, rounding_mode="floor")


@pytest.mark.parametrize("n_tiles, n_seg", [(6, 4), (256, 4), (256, 16), (7, 1)])
def test_rank_major_block_map(n_tiles, n_seg):
    """Every (tile, segment) gets exactly one block, its partials at row
    tile * n_seg + segment of the (T * n_seg) scratch; the blocks of each
    rank come before those of the next, so any prefix of the launch order
    (the blocks resident first) holds each tile's first segments."""
    tile, seg = block_map(n_tiles, n_seg)
    slot = tile * n_seg + seg
    assert torch.equal(torch.sort(slot).values, torch.arange(n_tiles * n_seg))
    assert bool((seg[1:] >= seg[:-1]).all())
    for prefix in (n_tiles, n_tiles * n_seg // 2 + 1, n_tiles * n_seg):
        per_tile = torch.bincount(tile[:prefix], minlength=n_tiles)
        assert int(per_tile.max() - per_tile.min()) <= 1
        assert bool((seg[:prefix] < per_tile[tile[:prefix]]).all())


@pytest.mark.parametrize("wave", [1, 5, 64])
def test_exact_skip_under_any_schedule(wave):
    """A model of pass 1's skip: blocks run in launch order in waves of
    `wave` resident blocks; each reads its tile's published index when its
    wave starts, skips (writes nothing) where that is below its segment,
    and publishes its segment where its own step saturates every pixel. The
    combine fed what was written (NaN elsewhere) gives the outputs of the
    full partials bit for bit, and with one resident block the saturated
    tile's later segments are skipped."""
    rows, u0, v0 = rows_at(44, "edge", 256)
    full = rc.tile_fwd_partials_plain(rows, u0, v0, C)
    n_seg = full.shape[1]
    written = torch.full_like(full, float("nan"))
    skip_from = torch.full((T,), 2**31 - 1)
    tile, seg = block_map(T, n_seg)
    for lo in range(0, T * n_seg, wave):
        seen = skip_from.clone()
        for t, s in zip(tile[lo : lo + wave].tolist(), seg[lo : lo + wave].tolist()):
            if seen[t] < s:
                continue
            written[t, s] = full[t, s]
            if float(full[t, s, :, C].max()) < rc.LOG_EPS:
                skip_from[t] = min(int(skip_from[t]), s)
    for a, b in zip(split(rows, u0, v0, partials=written), split(rows, u0, v0, partials=full)):
        assert torch.equal(a, b)
    if wave == 1:
        assert bool(torch.isnan(written[2, 1:]).all())


def test_pass_wrappers_check_their_inputs():
    """The pass wrappers check shapes and devices before they touch the
    card: CPU tensors are refused (the kernels take CUDA ones only)."""
    rows, u0, v0 = rows_at(45, "plain", 128)
    partials = rc.tile_fwd_partials_plain(rows, u0, v0, C)
    with pytest.raises(ValueError):  # out of the wrong width
        rc.tile_fwd_partials_cuda(rows, u0, v0, C, out=partials[..., :C])
    with pytest.raises(ValueError):  # out with the wrong segment count
        rc.tile_fwd_partials_cuda(rows, u0, v0, C, out=partials[:, :1])
    with pytest.raises(ValueError):
        rc.tile_fwd_partials_cuda(rows, u0, v0, C)
    with pytest.raises(ValueError):  # partials for another channel count
        rc.tile_fwd_combine_cuda(partials, C + 1)
    with pytest.raises(ValueError):
        rc.tile_fwd_combine_cuda(partials, C)
