"""The two passes of the CSR forward kernels (B3, B5) in their plain
versions: csr_combine_plain(csr_partials_plain(...)) against the sequential
twins (blend_csr_fwd_plain, blend_csr_dual_fwd_plain) and against the JAX
package's Pallas kernels in interpret mode, on test_torch_csr's streams; the
exactness of the kernels' skip of segments that the exit already rules
out; and the kernels' dead-pair test, swept across its threshold.

Tolerances. The split sums the same float32 log steps in the same order as
the twins, so logT, the stash and the band carry are compared bitwise; only
accum is reassociated (exp(logT) * sum in place of sum exp(excl + logT)):
1e-6 relative, 1e-7 of the largest value absolute. Against Pallas,
test_torch_csr's 1e-5 relative and 1e-4 absolute (cumsum against
Hillis-Steele)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_pallas import _blend_csr_fwd_pallas, blend_csr_dual_pallas
from activesplat_tpu_torch.ops import raster_cuda as rc
from tests.test_torch_csr import C, N_TILES, SATURATING, SEGMENTS, make_stream, torch_args
from tests.test_torch_topdown import band_rows, dual_stream

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DUAL_C = 3


def split(stream, n_channels, dual=False, with_entry=False, partials=None):
    """The two passes' plain versions chained: the kernels' algorithm."""
    data, seg_tile, seg_u0, seg_v0 = stream
    if partials is None:
        partials = rc.csr_partials_plain(data, seg_u0, seg_v0, n_channels, dual)
    return rc.csr_combine_plain(partials, seg_tile, N_TILES, n_channels, dual, with_entry)


def assert_accum_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7 * float(want.abs().max()))


def ones_stream(seed):
    """test_torch_csr's stream with every band bit set."""
    data, *maps = torch_args(make_stream(np.random.default_rng(seed)))
    data[:, rc.BAND_COL] = 1.0
    return (data, *maps)


def test_split_b3_matches_sequential_twin():
    """B3 split in two passes: logT and the stash of every segment bitwise
    the sequential twin's, the image within the reassociation's rounding;
    the saturating tile's second segment is skipped, tiles with no segment
    and padding segments get zeros."""
    args = torch_args(make_stream(np.random.default_rng(31)))
    accum, logt, entry = split(args, C, with_entry=True)
    accum_t, logt_t, entry_t = rc.blend_csr_fwd_plain(*args, N_TILES, C, with_entry=True)
    assert torch.equal(logt, logt_t) and torch.equal(entry, entry_t)
    assert_accum_close(accum, accum_t)
    assert logt[SATURATING].max() < rc.LOG_EPS
    first = int(np.sum(SEGMENTS[:SATURATING]))
    assert entry[first + 1].max() < rc.LOG_EPS  # the exit skips the second segment
    empty = torch.from_numpy(np.array(SEGMENTS) == 0)
    assert not accum[empty].any() and not logt[empty].any()
    assert not entry[args[1] >= N_TILES].any()


def test_split_b5_matches_twin_and_keeps_identities_to_b3():
    """B5 split in two passes: logT and the band carry bitwise the dual
    twin's; the band carry bitwise B3's split logT over the band rows; with
    every band bit set, (accum, logT) bitwise B3's split and the band carry
    the full one."""
    args = [torch.from_numpy(x) for x in dual_stream(32)]
    accum, logt, logt_band = split(args, DUAL_C, dual=True)
    accum_t, logt_t, band_t = rc.blend_csr_dual_fwd_plain(*args, N_TILES, DUAL_C)
    assert torch.equal(logt, logt_t) and torch.equal(logt_band, band_t)
    assert_accum_close(accum, accum_t)
    _, logt_b3 = split([band_rows(args[0]), *args[1:]], DUAL_C)
    assert torch.equal(logt_band, logt_b3)
    ones = ones_stream(33)
    accum_1, logt_1, band_1 = split(ones, DUAL_C, dual=True)
    accum_3, logt_3 = split(ones, DUAL_C)
    assert torch.equal(accum_1, accum_3) and torch.equal(logt_1, logt_3)
    assert torch.equal(band_1, logt_1)


@pytest.mark.parametrize("dual", [False, True])
def test_split_matches_pallas(dual):
    """The split model against the Pallas kernel in interpret mode: visited
    tiles' image and logT (and B5's band logT, B3's stash of every segment
    of a tile); tiles with no segment get zeros."""
    vis = np.array(SEGMENTS) > 0
    if dual:
        stream = dual_stream(34)
        ref = blend_csr_dual_pallas(*map(jnp.asarray, stream), N_TILES, n_channels=DUAL_C,
                                    interpret=True)
        got = split([torch.from_numpy(x) for x in stream], DUAL_C, dual=True)
    else:
        stream = make_stream(np.random.default_rng(35))
        ref = _blend_csr_fwd_pallas(*map(jnp.asarray, stream), N_TILES, n_channels=C,
                                    interpret=True, with_entry=True)
        got = split(torch_args(stream), C, with_entry=True)
        walked = stream[1] < N_TILES
        np.testing.assert_allclose(got[2].numpy()[walked], np.asarray(ref[2])[walked, 0],
                                   rtol=1e-5, atol=1e-4)
    n = 3 if dual else 2  # image, logT and B5's band logT
    for g, r in zip(got[:n], ref[:n]):
        np.testing.assert_allclose(g.numpy()[vis], np.asarray(r)[vis], rtol=1e-5, atol=1e-4)
        assert np.all(g.numpy()[~vis] == 0)


def ruled_out(partials, seg_tile, step_col):
    """The segments that the kernels may leave uncomputed: each one after a
    segment of its tile whose own step (column `step_col`) leaves every
    pixel below LOG_EPS, and every padding segment."""
    own = (partials[:, :, step_col].amax(dim=1) < rc.LOG_EPS).tolist()
    tiles = seg_tile.tolist()
    out = [t >= N_TILES for t in tiles]
    for s in range(1, len(tiles)):
        out[s] |= tiles[s] == tiles[s - 1] and (own[s - 1] or out[s - 1])
    return torch.tensor(out)


@pytest.mark.parametrize("dual", [False, True])
def test_skipped_partials_are_never_read(dual):
    """The kernels' skip is exact: with the partials of every segment that
    the skip may leave uncomputed (and of the padding segments) set to NaN,
    the combine's outputs are bitwise unchanged. B5 tests its band step: on
    a stream with every band bit set its saturating tile's second segment
    is ruled out."""
    stream = ones_stream(36) if dual else torch_args(make_stream(np.random.default_rng(36)))
    c = DUAL_C if dual else C
    partials = rc.csr_partials_plain(stream[0], stream[2], stream[3], c, dual)
    skip = ruled_out(partials, stream[1], c + int(dual))
    first = int(np.sum(SEGMENTS[:SATURATING]))
    assert skip[first + 1] and not skip[: first + 1].any()
    holed = partials.clone()
    holed[skip] = float("nan")
    want = split(stream, c, dual, with_entry=not dual, partials=partials)
    got = split(stream, c, dual, with_entry=not dual, partials=holed)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("op", [0.0, 1e-3, 0.02, 0.5, 0.99, 1.0])
def test_dead_pair_test_is_conservative(op):
    """No (row, pixel) pair that the kernels' dead-pair test kills is live by
    the full formula, in float32 (the kernels' arithmetic) or float64, over
    a float32 sweep of power across [thr - 0.01, thr + 0.01]; the test kills
    every pair more than two margins below the exact boundary
    log(ALPHA_MIN / op); a flipped margin would kill live pairs."""
    op32 = torch.tensor(op, dtype=torch.float32)
    thr = rc.dead_pair_threshold(op32)
    centre = float(thr) if op > 0 else float(np.log(rc.ALPHA_MIN))
    power = torch.linspace(centre - 0.01, centre + 0.01, 200_001, dtype=torch.float32)
    if op > 0:  # and the float32 neighbours of the threshold itself
        near = torch.tensor(centre, dtype=torch.float32) + torch.arange(-64, 65) * 1e-7
        power = torch.cat([power, near.to(torch.float32)])

    def killed(t):
        return (power > 0) | (power < t)

    live32 = (power <= 0) & (torch.clamp(op32 * torch.exp(power), max=rc.ALPHA_MAX) >= rc.ALPHA_MIN)
    p64 = power.double().numpy()
    live64 = torch.from_numpy((p64 <= 0) & (np.minimum(op * np.exp(p64), 0.99) >= 1 / 255))
    dead = killed(thr)
    assert not (dead & live32).any() and not (dead & live64).any()
    if op > 0:
        boundary = np.log((1 / 255) / op)
        assert dead[torch.from_numpy(p64 < boundary - 2 * rc.DEAD_MARGIN)].all()
    if op > 1 / 255:
        flipped = killed(rc.dead_pair_threshold(op32, -rc.DEAD_MARGIN))
        assert (flipped & live32).any()
