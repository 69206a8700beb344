"""The port's tile-blend twins (the CPU path of kernels B1 and B2) against the
JAX package's Pallas kernels run in interpret mode, on the same rows made
with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops.raster_pallas import (
    _blend_fwd_pallas,
    blend_tiles as jax_blend_tiles,
    blend_tiles_pallas,
)
from activesplat_tpu_torch import _build
from activesplat_tpu_torch.ops import raster_cuda as rc

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

T, K, C = 6, 128, 5
PAD_ROW = np.array([-1e9, -1e9, 1.0, 1.0, 1.0] + [0.0] * 11, np.float32)


def make_rows(rng, case):
    """Tile rows around each tile's own pixels. Tiles 0-1 hold ordinary
    lists, tile 2 saturates in its first segment, tile 3 is empty (padding
    rows only), tiles 4-5 hold 96 rows padded to K=128."""
    u0 = (np.arange(T) % 3 * rc.TILE).astype(np.int32)
    v0 = (np.arange(T) // 3 * rc.TILE).astype(np.int32)
    rows = np.zeros((T, K, rc.N_ATTR), np.float32)
    rows[:, :, 0] = u0[:, None] + rng.uniform(-6, 22, (T, K))
    rows[:, :, 1] = v0[:, None] + rng.uniform(-6, 22, (T, K))
    rows[:, :, 2] = rng.uniform(0.05, 0.6, (T, K))
    rows[:, :, 3] = rng.uniform(-0.05, 0.05, (T, K))
    rows[:, :, 4] = rng.uniform(0.05, 0.6, (T, K))
    rows[:, :, 5] = rng.uniform(0.02, 0.3, (T, K))
    rows[:, :, 6 : 6 + C] = rng.uniform(0, 1, (T, K, C))
    if case == "edge":
        rows[2, :, 2] = rng.uniform(0.001, 0.004, K)  # wide and opaque
        rows[2, :, 3] = 0.0
        rows[2, :, 4] = rng.uniform(0.001, 0.004, K)
        rows[2, :, 5] = 0.95
        rows[3] = PAD_ROW
        rows[4:, 96:] = PAD_ROW
    return rows, u0, v0


def assert_clear_of_eps(entry):
    """Both sides decide the early exit on max logT < LOG_EPS at each
    segment start; keep the test data clear of that boundary (within
    rounding the two may decide differently, test_pallas.py:53-55)."""
    seg_max = entry.max(axis=2)
    assert np.all(np.abs(seg_max - rc.LOG_EPS) > 0.05), seg_max


@pytest.mark.parametrize("case", ["plain", "edge"])
@pytest.mark.parametrize("with_entry", [False, True])
def test_fwd_twin_matches_pallas(case, with_entry):
    """Tolerance: the same float32 algorithm with the in-segment prefix
    summed by cumsum instead of Hillis-Steele; sums of at most 128 logs
    differ by float32 rounding, well below 1e-4."""
    rows, u0, v0 = make_rows(np.random.default_rng(11), case)
    args = (jnp.asarray(rows), jnp.asarray(u0), jnp.asarray(v0))
    if with_entry:
        ref = _blend_fwd_pallas(*args, n_channels=C, interpret=True, with_entry=True)
    else:
        ref = blend_tiles_pallas(*args, n_channels=C, interpret=True)
    got = rc.blend_tiles_fwd(
        torch.from_numpy(rows), torch.from_numpy(u0), torch.from_numpy(v0), C,
        with_entry=with_entry,
    )
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)
    if with_entry:
        assert_clear_of_eps(got[2].numpy())
    if case == "edge":
        assert np.all(got[0][3].numpy() == 0) and np.all(got[1][3].numpy() == 0)
        assert got[1][2].max() < rc.LOG_EPS  # tile 2 saturated


@pytest.mark.parametrize("case", ["plain", "edge"])
def test_bwd_twin_matches_pallas_vjp(case):
    """B2's twin against jax.vjp of the Pallas blend. Tolerance: float32
    rounding of sums over 256 pixels and 128 rows, 1e-4 of the largest
    gradient."""
    rng = np.random.default_rng(12)
    rows, u0, v0 = make_rows(rng, case)
    g_acc = rng.normal(size=(T, rc.PX, C)).astype(np.float32)
    g_lt = rng.normal(size=(T, rc.PX)).astype(np.float32)

    _, vjp = jax.vjp(
        lambda d: jax_blend_tiles(d, jnp.asarray(u0), jnp.asarray(v0), C, True),
        jnp.asarray(rows),
    )
    (ref,) = vjp((jnp.asarray(g_acc), jnp.asarray(g_lt)))
    ref = np.asarray(ref)

    t_rows, t_u0, t_v0 = (torch.from_numpy(x) for x in (rows, u0, v0))
    _, _, entry = rc.blend_tiles_fwd(t_rows, t_u0, t_v0, C, with_entry=True)
    assert_clear_of_eps(entry.numpy())
    got = rc.blend_tiles_bwd(
        t_rows, t_u0, t_v0, entry, torch.from_numpy(g_acc), torch.from_numpy(g_lt), C
    ).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    assert np.all(got[:, :, 14:] == 0)
    if case == "edge":
        assert np.all(got[3] == 0)  # empty tile: no gradient
        assert np.all(got[2, 64:] == 0)  # saturated segment: zero rows


def test_autograd_function_uses_bwd_formula():
    """BlendTiles on CPU tensors: autograd's gradient is exactly the
    backward twin's output for the same cotangents."""
    rng = np.random.default_rng(13)
    rows, u0, v0 = make_rows(rng, "edge")
    t_rows = torch.from_numpy(rows).requires_grad_(True)
    t_u0, t_v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    accum, logt = rc.blend_tiles(t_rows, t_u0, t_v0, C)
    g_acc = torch.from_numpy(rng.normal(size=accum.shape).astype(np.float32))
    g_lt = torch.from_numpy(rng.normal(size=logt.shape).astype(np.float32))
    (grad,) = torch.autograd.grad((accum * g_acc).sum() + (logt * g_lt).sum(), t_rows)
    _, _, entry = rc.blend_tiles_fwd_plain(t_rows.detach(), t_u0, t_v0, C, with_entry=True)
    want = rc.blend_tiles_bwd_plain(t_rows.detach(), t_u0, t_v0, entry, g_acc, g_lt, C)
    assert torch.equal(grad, want)


def test_cpu_path_launches_no_kernel():
    """The wrappers count kernel launches only; the CPU path runs the twins."""
    rows, u0, v0 = make_rows(np.random.default_rng(14), "plain")
    rc.reset_launch_counts()
    t_rows, t_u0, t_v0 = (torch.from_numpy(x) for x in (rows, u0, v0))
    _, _, entry = rc.blend_tiles_fwd(t_rows, t_u0, t_v0, C, with_entry=True)
    rc.blend_tiles_bwd(
        t_rows, t_u0, t_v0, entry, torch.zeros((T, rc.PX, C)), torch.zeros((T, rc.PX)), C
    )
    # the same rows as a CSR stream: K=128 rows per tile, two tiles a segment
    seg = torch.arange(T // 2, dtype=torch.int32)
    csr = t_rows.reshape(-1, rc.N_ATTR)
    _, _, entry = rc.blend_csr_fwd(csr, seg, t_u0[::2], t_v0[::2], T // 2, C, with_entry=True)
    rc.blend_csr_bwd(csr, seg, t_u0[::2], t_v0[::2], entry, torch.zeros((T // 2, rc.PX, C)),
                     torch.zeros((T // 2, rc.PX)), T // 2, C)
    rc.blend_csr_dual_fwd(csr, seg, t_u0[::2], t_v0[::2], T // 2, C)
    # the bin route's two passes: 200 Gaussians (two blocks) over a 4x4 grid
    bounds = torch.zeros(200)
    words, counts = rc.bin_count(torch.ones(200, dtype=torch.bool), *(bounds,) * 4, 4, 4)
    rc.bin_slots(counts.cumsum(0, dtype=torch.int32), words, 128, 0, 4, 200)
    assert [fn.launches for fn in rc.KERNELS] == [0] * 7


@pytest.mark.parametrize(
    "bad",
    [
        lambda r, u, v: (r[:, :100], u, v),  # K not a SEG multiple
        lambda r, u, v: (r.double(), u, v),  # wrong dtype
        lambda r, u, v: (r, u.long(), v),  # wrong origin dtype
    ],
)
def test_wrapper_rejects_bad_rows(bad):
    rows, u0, v0 = make_rows(np.random.default_rng(15), "plain")
    args = bad(*(torch.from_numpy(x) for x in (rows, u0, v0)))
    with pytest.raises(ValueError):
        rc.blend_tiles_fwd(*args, C)


def test_build_targets_hopper_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name in _build.SOURCES:
        head = (_build.CSRC / f"{name}.cu").read_text()[:1500]
        assert "Replaces: activesplat_tpu/ops/raster_pallas.py" in head
