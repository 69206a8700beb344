"""The port's CSR blend twins (the CPU path of kernels B3 and B4) against the
JAX package's Pallas kernels run in interpret mode, on the same CSR streams
made with numpy, and the autograd Function that pairs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_pallas import _blend_csr_fwd_pallas
from activesplat_tpu.ops.raster_pallas import blend_csr as jax_blend_csr
from activesplat_tpu_torch.ops import raster_cuda as rc

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

C = 5
TILES_X, TILES_Y = 4, 2
N_TILES = TILES_X * TILES_Y
PAD_ROW = np.array([-1e9, -1e9, 1.0, 1.0, 1.0] + [0.0] * 11, np.float32)
# segments per tile: one, several, none, a saturating run, a run whose last
# segment is mostly padding rows
SEGMENTS = [1, 3, 0, 2, 1, 0, 2, 1]
SATURATING = 3
N_PAD_SEGMENTS = 2  # trailing segments keyed to the padding tile N_TILES


def make_stream(rng):
    """(entry_data (E, 16), seg_tile, seg_u0, seg_v0) with every tile's run
    CSEG-aligned and two padding segments at the end."""
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
        r[:, 6 : 6 + C] = rng.uniform(0, 1, (n, C))
        if tile == SATURATING:  # wide and opaque: saturates in its first segment
            r[:, 2] = rng.uniform(0.001, 0.004, n)
            r[:, 3] = 0.0
            r[:, 4] = rng.uniform(0.001, 0.004, n)
            r[:, 5] = 0.95
        if tile == 7:
            r[40:] = PAD_ROW  # 40 members, padded to CSEG
        rows.append(r)
        seg_tile += [tile] * n_seg
    seg_tile = np.array(seg_tile, np.int32)
    in_grid = seg_tile < N_TILES
    seg_u0 = np.where(in_grid, seg_tile % TILES_X * rc.TILE, 0).astype(np.int32)
    seg_v0 = np.where(in_grid, seg_tile // TILES_X * rc.TILE, 0).astype(np.int32)
    return np.concatenate(rows), seg_tile, seg_u0, seg_v0


def torch_args(stream):
    return tuple(torch.from_numpy(x) for x in stream)


def visited():
    return np.array(SEGMENTS) > 0


def walked_segments(seg_tile):
    return seg_tile < N_TILES


def assert_clear_of_eps(entry, seg_tile):
    """Both sides decide the early exit on max logT < LOG_EPS at each
    segment start; keep the data clear of that boundary, where the two may
    decide differently within rounding (test_pallas.py:53-55)."""
    seg_max = entry[walked_segments(seg_tile)].max(axis=1)
    assert np.all(np.abs(seg_max - rc.LOG_EPS) > 0.05), seg_max
    assert np.any(seg_max < rc.LOG_EPS), "a saturated segment must be skipped"


@pytest.mark.parametrize("with_entry", [False, True])
def test_csr_fwd_twin_matches_pallas(with_entry):
    """Visited tiles' image and logT, and the stash of every segment of a
    tile, against the Pallas kernel. Tolerance: the same float32 algorithm
    with the in-segment prefix summed by cumsum instead of Hillis-Steele;
    sums of up to 768 logs, 1e-5 relative and 1e-4 absolute."""
    stream = make_stream(np.random.default_rng(21))
    ref = _blend_csr_fwd_pallas(
        *map(jnp.asarray, stream), N_TILES, n_channels=C, interpret=True, with_entry=with_entry
    )
    got = rc.blend_csr_fwd(*torch_args(stream), N_TILES, C, with_entry=with_entry)
    assert len(got) == len(ref)
    vis = visited()
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy()[vis], np.asarray(r)[vis], rtol=1e-5, atol=1e-4)
        assert np.all(g.numpy()[~vis] == 0)  # tiles with no segment: zeros
    if with_entry:
        walked = walked_segments(stream[1])
        entry = got[2].numpy()
        np.testing.assert_allclose(
            entry[walked], np.asarray(ref[2])[walked, 0], rtol=1e-5, atol=1e-4
        )
        assert np.all(entry[~walked] == 0)
        assert_clear_of_eps(entry, stream[1])
    assert got[1][SATURATING].max() < rc.LOG_EPS


def test_csr_bwd_twin_matches_pallas_vjp():
    """B4's twin against jax.vjp of the Pallas CSR blend. Tolerance: float32
    rounding of sums over 256 pixels and up to 768 rows, 1e-4 of the
    largest gradient."""
    rng = np.random.default_rng(22)
    stream = make_stream(rng)
    g_acc = rng.normal(size=(N_TILES, rc.PX, C)).astype(np.float32)
    g_lt = rng.normal(size=(N_TILES, rc.PX)).astype(np.float32)
    maps = tuple(jnp.asarray(x) for x in stream[1:])
    _, vjp = jax.vjp(
        lambda d: jax_blend_csr(d, *maps, N_TILES, C, True), jnp.asarray(stream[0])
    )
    (ref,) = vjp((jnp.asarray(g_acc), jnp.asarray(g_lt)))
    ref = np.asarray(ref)

    args = torch_args(stream)
    _, _, entry = rc.blend_csr_fwd(*args, N_TILES, C, with_entry=True)
    assert_clear_of_eps(entry.numpy(), stream[1])
    got = rc.blend_csr_bwd(
        *args, entry, torch.from_numpy(g_acc), torch.from_numpy(g_lt), N_TILES, C
    ).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    assert np.all(got[:, 14:] == 0)
    first = np.concatenate([[0], np.cumsum(SEGMENTS)]) * rc.CSEG
    sat = slice(first[SATURATING] + rc.CSEG, first[SATURATING + 1])
    assert np.all(got[sat] == 0)  # the skipped segment: zero rows
    assert np.all(got[first[-1]:] == 0)  # padding segments: zero rows
    assert np.abs(got[: rc.CSEG, :14]).max() > 0


def test_csr_autograd_function_uses_bwd_formula():
    """BlendCSR on CPU tensors: autograd's gradient is exactly the backward
    twin's output for the same cotangents; the carry restarts per tile."""
    rng = np.random.default_rng(23)
    data, seg_tile, seg_u0, seg_v0 = torch_args(make_stream(rng))
    leaf = data.clone().requires_grad_(True)
    accum, logt = rc.blend_csr(leaf, seg_tile, seg_u0, seg_v0, N_TILES, C)
    g_acc = torch.from_numpy(rng.normal(size=accum.shape).astype(np.float32))
    g_lt = torch.from_numpy(rng.normal(size=logt.shape).astype(np.float32))
    (grad,) = torch.autograd.grad((accum * g_acc).sum() + (logt * g_lt).sum(), leaf)
    _, _, entry = rc.blend_csr_fwd_plain(data, seg_tile, seg_u0, seg_v0, N_TILES, C, True)
    want = rc.blend_csr_bwd_plain(data, seg_tile, seg_u0, seg_v0, entry, g_acc, g_lt, N_TILES, C)
    assert torch.equal(grad, want)
    # tile 1's three segments alone give tile 1's gradient rows
    first = int(np.sum(SEGMENTS[:1])) * rc.CSEG
    rows1 = slice(first, first + 3 * rc.CSEG)
    one = torch.zeros(3, dtype=torch.int32)
    alone = rc.blend_csr_bwd_plain(
        data[rows1].contiguous(), one, seg_u0[1:4], seg_v0[1:4], entry[1:4],
        g_acc[1:2], g_lt[1:2], 1, C,
    )
    scale = float(want[rows1].abs().max())
    torch.testing.assert_close(alone, want[rows1], rtol=1e-6, atol=1e-6 * scale)


def test_csr_twins_on_an_empty_stream():
    """No entries at all: every tile is empty and gets zeros."""
    empty = torch.zeros((0, rc.N_ATTR))
    maps = [torch.zeros((0,), dtype=torch.int32)] * 3
    accum, logt, entry = rc.blend_csr_fwd(empty, *maps, 4, C, with_entry=True)
    assert accum.shape == (4, rc.PX, C) and not accum.any() and not logt.any()
    d = rc.blend_csr_bwd(empty, *maps, entry, torch.ones((4, rc.PX, C)), torch.ones((4, rc.PX)), 4, C)
    assert d.shape == (0, rc.N_ATTR)


@pytest.mark.parametrize(
    "bad",
    [
        lambda d, t, u, v: (d[:100], t, u, v),  # E not a CSEG multiple
        lambda d, t, u, v: (d.double(), t, u, v),  # wrong dtype
        lambda d, t, u, v: (d, t.long(), u, v),  # wrong segment map dtype
        lambda d, t, u, v: (d, t[:-1], u, v),  # wrong segment count
    ],
)
def test_csr_wrapper_rejects_bad_streams(bad):
    args = bad(*torch_args(make_stream(np.random.default_rng(24))))
    with pytest.raises(ValueError):
        rc.blend_csr_fwd(*args, N_TILES, C)


def test_csr_wrappers_refuse_other_devices():
    """A CSR wrapper runs its twin only for CPU tensors."""
    rows = torch.zeros((rc.CSEG, 16), device="meta")
    seg = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        rc.blend_csr_fwd(rows, seg, seg, seg, 1, C)
