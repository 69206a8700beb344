"""The two passes of the tile-blend backward B2 in their plain versions:
tile_bwd_walk_plain(tile_bwd_suffix_plain(...)) against the sequential twin
(blend_tiles_bwd_plain) and against jax.vjp of the JAX package's Pallas
blend run in interpret mode, on test_torch_kernels' rows at K=128 and
K=256 (two and four 64-row segments); the skipped segments of a saturated
tile; and models, in torch, of two pieces of the kernels' index arithmetic:
the warp's reduce-scatter butterfly and the per-warp reach mask.

Tolerances. The split folds the later segments' totals in the sequential
twin's order, so it is compared bitwise; against Pallas,
test_bwd_twin_matches_pallas_vjp's 1e-4 relative and 1e-4 of the largest
gradient (float32 sums over 256 pixels and up to 256 rows, cumsum against
Hillis-Steele)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_pallas import blend_tiles as jax_blend_tiles
from activesplat_tpu_torch.ops import raster_cuda as rc
from tests.test_torch_kernels import C, PAD_ROW, T, assert_clear_of_eps

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

LANES, N_COLS = 32, 16  # a warp; the values a lane feeds the butterfly


def make_rows(rng, case, k):
    """test_torch_kernels' rows at K=k: tiles 0-1 ordinary lists, tile 2
    saturating in its first segment, tile 3 empty, tiles 4-5 holding 3K/4
    rows padded to K ("edge")."""
    u0 = (np.arange(T) % 3 * rc.TILE).astype(np.int32)
    v0 = (np.arange(T) // 3 * rc.TILE).astype(np.int32)
    rows = np.zeros((T, k, rc.N_ATTR), np.float32)
    rows[:, :, 0] = u0[:, None] + rng.uniform(-6, 22, (T, k))
    rows[:, :, 1] = v0[:, None] + rng.uniform(-6, 22, (T, k))
    rows[:, :, 2] = rng.uniform(0.05, 0.6, (T, k))
    rows[:, :, 3] = rng.uniform(-0.05, 0.05, (T, k))
    rows[:, :, 4] = rng.uniform(0.05, 0.6, (T, k))
    rows[:, :, 5] = rng.uniform(0.02, 0.3, (T, k))
    rows[:, :, 6 : 6 + C] = rng.uniform(0, 1, (T, k, C))
    if case == "edge":
        rows[2, :, 2] = rng.uniform(0.001, 0.004, k)  # wide and opaque
        rows[2, :, 3] = 0.0
        rows[2, :, 4] = rng.uniform(0.001, 0.004, k)
        rows[2, :, 5] = 0.95
        rows[3] = PAD_ROW
        rows[4:, 3 * k // 4 :] = PAD_ROW
    return rows, u0, v0


def backward_inputs(seed, case, k):
    rng = np.random.default_rng(seed)
    rows, u0, v0 = make_rows(rng, case, k)
    g_acc = rng.normal(size=(T, rc.PX, C)).astype(np.float32)
    g_lt = rng.normal(size=(T, rc.PX)).astype(np.float32)
    t_rows, t_u0, t_v0 = (torch.from_numpy(x) for x in (rows, u0, v0))
    _, _, entry = rc.blend_tiles_fwd(t_rows, t_u0, t_v0, C, with_entry=True)
    return (t_rows, t_u0, t_v0, entry, torch.from_numpy(g_acc), torch.from_numpy(g_lt))


def split(rows, u0, v0, entry, g_acc, g_lt):
    """The two passes' plain versions chained: the kernels' algorithm."""
    suffix = rc.tile_bwd_suffix_plain(rows, u0, v0, entry, g_acc, C)
    return suffix, rc.tile_bwd_walk_plain(rows, u0, v0, entry, g_acc, g_lt, suffix, C)


@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("case", ["plain", "edge"])
def test_plain_split_is_the_sequential_twin(case, k):
    """Fed the segments' own totals, the fold gives every segment the carry
    of the sequential walk bit for bit, so the split's gradient rows are
    blend_tiles_bwd_plain's."""
    args = backward_inputs(21, case, k)
    suffix, d_rows = split(*args)
    assert suffix.shape == (T, k // rc.SEG, rc.PX)
    assert torch.equal(d_rows, rc.blend_tiles_bwd_plain(*args, C))


@pytest.mark.parametrize("case", ["plain", "edge"])
def test_plain_split_matches_pallas_vjp(case):
    """The split against jax.vjp of the Pallas blend (interpret mode) at
    K=256, four segments."""
    rows, u0, v0, entry, g_acc, g_lt = backward_inputs(22, case, 256)
    assert_clear_of_eps(entry.numpy())
    _, vjp = jax.vjp(
        lambda d: jax_blend_tiles(d, jnp.asarray(u0.numpy()), jnp.asarray(v0.numpy()), C, True),
        jnp.asarray(rows.numpy()),
    )
    (ref,) = vjp((jnp.asarray(g_acc.numpy()), jnp.asarray(g_lt.numpy())))
    ref = np.asarray(ref)
    got = split(rows, u0, v0, entry, g_acc, g_lt)[1].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert np.all(got[:, :, 14:] == 0)


def test_skipped_segments_get_exact_zeros():
    """The saturated tile's segments after its first were skipped by the
    forward: their totals are exactly 0.0 and their gradient rows zero, as
    are those of the empty tile (walked, every pair dead); the walked
    segments' totals of an ordinary tile are not."""
    args = backward_inputs(23, "edge", 256)
    entry = args[3]
    suffix, d_rows = split(*args)
    skipped = entry.amax(dim=2) < rc.LOG_EPS
    assert bool(skipped[2, 1:].all()) and not bool(skipped[2, 0])  # tile 2 saturates at once
    assert bool((suffix[skipped] == 0.0).all()) and bool((suffix[3] == 0.0).all())
    assert bool((d_rows[3] == 0.0).all())
    assert bool((suffix[0] != 0.0).any(dim=1).all())
    rows_skipped = skipped.repeat_interleave(rc.SEG, dim=1)
    assert bool((d_rows[rows_skipped] == 0.0).all())
    assert bool(d_rows[2, : rc.SEG].abs().amax() > 0)


def butterfly(v):
    """The walk's reduce-scatter (blend_bwd.cu, butterfly_step and
    warp_column_sum) on a (32 lanes, 16 values) array: at OFF = 16, 8, 4, 2
    each lane keeps the HALF of its values that its lane bit OFF selects
    and adds its partner's (lane ^ OFF) copy of them; at 1 the pair adds its
    one value. Returns each lane's result."""
    lanes = torch.arange(LANES)
    for half, off in ((8, 16), (4, 8), (2, 4), (1, 2)):
        upper = ((lanes & off) != 0)[:, None]
        keep = torch.where(upper, v[:, half : 2 * half], v[:, :half])
        send = torch.where(upper, v[:, :half], v[:, half : 2 * half])
        v = keep + send[lanes ^ off]
    return v[:, 0] + v[lanes ^ 1, 0]


@pytest.mark.parametrize("n_channels", range(1, 9))
def test_butterfly_lane_map(n_channels):
    """Column c's warp sum lands in lanes 2c and 2c + 1 (the even lane
    writes it) with 16 exchanges for the 6 + C <= 16 gradients; the sums
    match sum(dim=0) within float32 rounding of 32 terms, and the padded
    columns stay exactly zero."""
    nv = 6 + n_channels
    assert nv <= N_COLS
    gen = torch.Generator().manual_seed(n_channels)
    v = torch.zeros((LANES, N_COLS))
    v[:, :nv] = torch.randn((LANES, nv), generator=gen)
    v[::3] = 0.0  # dead lanes contribute zeros
    got = butterfly(v.clone())
    assert torch.equal(got[0::2], got[1::2])
    want = v.double().sum(dim=0)
    scale = v.abs().sum(dim=0).double()
    assert bool(((got[0::2].double() - want).abs() <= 32 * 2.0**-24 * scale).all())
    assert bool((got[2 * nv :: 2] == 0).all())


def reach_mask(rows, u0, v0, margin=rc.DEAD_MARGIN):
    """blend_bwd.cu's reach_mask in float32: (T, K, 8) per warp, True where
    the warp's 8x4-pixel block (x 8(w%2)..+7, y 4(w/2)..+3) may hold a pair
    of the row with power >= thr."""
    a, b, c = rows[..., 2], rows[..., 3], rows[..., 4]
    thr = rc.dead_pair_threshold(rows[..., 5], margin)
    det = a * c - b * b
    reach = -2.0 * thr
    ok = (reach > 0) & torch.isfinite(reach) & (a > 0) & (c > 0) & (det > 1e-3 * a * c)
    ex = torch.sqrt(reach * c / det) * 1.001 + 0.01
    ey = torch.sqrt(reach * a / det) * 1.001 + 0.01
    w = torch.arange(8)
    xl = (u0[:, None, None] + 8 * (w % 2)).float()
    yl = (v0[:, None, None] + 4 * (w // 2)).float()
    mx, my, ex, ey = (x[..., None] for x in (rows[..., 0], rows[..., 1], ex, ey))
    inside = ~((mx + ex < xl) | (mx - ex > xl + 7) | (my + ey < yl) | (my - ey > yl + 3))
    return torch.where(ok[..., None], inside, torch.isfinite(thr)[..., None])


def test_reach_mask_keeps_every_live_pair():
    """No live pair (alpha >= ALPHA_MIN by the full formula) lies in a warp
    that the reach mask rules out, on the edge rows and on rows with long,
    turned ellipses; the mask does rule out most warp-rows of small
    Gaussians."""
    rng = np.random.default_rng(24)
    rows, u0, v0 = (torch.from_numpy(x) for x in make_rows(rng, "edge", 256))
    turned = rows.clone()
    theta = torch.from_numpy(rng.uniform(0, np.pi, turned.shape[:2]).astype(np.float32))
    long_, short = 0.002, 0.5  # inverse variances along and across
    cos, sin = torch.cos(theta), torch.sin(theta)
    turned[..., 2] = long_ * cos**2 + short * sin**2
    turned[..., 3] = (long_ - short) * cos * sin
    turned[..., 4] = long_ * sin**2 + short * cos**2
    turned[..., 5] = 0.9
    small = rows.clone()
    small[..., 2:5] = torch.tensor([0.8, 0.0, 0.8])
    for data in (rows, turned, small):
        mask = reach_mask(data, u0, v0)
        px, py = rc._pixel_coords(u0, v0)
        live = rc._segment_geometry(data, px, py)[5].view(T, -1, 4, 4, 2, 8)  # (T, K, yb, y, xb, x)
        live_w = live.any(dim=5).any(dim=3).reshape(T, -1, 8)
        assert not bool((live_w & ~mask).any())
    assert float(reach_mask(small, u0, v0).float().mean()) < 0.5


def test_pass_wrappers_check_their_inputs():
    """The pass wrappers check shapes before they touch the card."""
    rows, u0, v0, entry, g_acc, g_lt = backward_inputs(25, "plain", 128)
    with pytest.raises(ValueError):
        rc.tile_bwd_walk_cuda(rows, u0, v0, entry, g_acc, g_lt, entry[:, :1], C)
    with pytest.raises(ValueError):
        rc.tile_bwd_suffix_cuda(rows, u0, v0, entry[:, :1], g_acc, C)
    with pytest.raises(ValueError):  # CPU tensors: the kernels take CUDA ones only
        rc.tile_bwd_suffix_cuda(rows, u0, v0, entry, g_acc, C)
