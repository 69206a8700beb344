"""The bin kernel route's two passes (B6) in their plain versions: the count
pass (bin_count_plain) against a brute-force count per (block, tile) in
numpy; the slot pass (bin_slots_plain) on the (nb, T) cumsum against the
JAX package's bin_slots_pallas in interpret mode, fed the same cumsum and
the byte planes the reference builds; chip_smoke.py's torch model of the
CUDA slot pass's algorithm (per-block window test, ranks by popcount in
lane order, the sentinel tail) against bin_slots_plain; and the pass
wrappers refusing bad inputs. Every comparison is bitwise: the outputs are
integers."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from activesplat_tpu.ops.raster_pallas import bin_slots_pallas
from activesplat_tpu_torch.ops import raster_cuda as rc
from activesplat_tpu_torch.ops.raster_tiled import tile_aabbs

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BLK = rc.BIN_BLOCK
# chip_smoke.py's torch model of the CUDA slot pass, which the smoke also
# holds against the kernel and plants its faults in
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def bounds(n, w, h, seed, spread=20.0, radius=(1.0, 25.0), skew=1.0):
    """n splats over a w x h image and `spread` px beyond it (denser toward
    the origin for skew > 1), 15% invalid, the first four far off the grid:
    tile_aabbs' (valid, tx0, tx1, ty0, ty1) and the grid's size."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n, 2)) ** skew
    mean2d = (u * (max(w, h) + 2 * spread) - spread).astype(np.float32)
    mean2d[:4] = [[-200.0, 10.0], [10.0, -200.0], [w + 200.0, 10.0], [10.0, h + 200.0]]
    rad = rng.uniform(*radius, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15
    tiles_x, tiles_y = -(-w // rc.TILE), -(-h // rc.TILE)
    m = torch.from_numpy(mean2d)
    out = tile_aabbs(m[:, 0], m[:, 1], torch.from_numpy(rad), torch.from_numpy(valid), tiles_x,
                     tiles_y)
    return out, tiles_x, tiles_y


def brute_force(valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y):
    """The count pass in numpy, one membership at a time: (words, counts)."""
    n = valid.shape[0]
    nb = -(-n // BLK)
    counts = np.zeros((nb, tiles_x * tiles_y), np.int32)
    words = np.full(nb * BLK, 0xFF000000, np.uint32)
    for g in range(n):
        x0, x1, y0, y1 = (int(v[g]) for v in (tx0, tx1, ty0, ty1))
        if valid[g]:
            words[g] = x0 << 24 | x1 << 16 | y0 << 8 | y1
            for y in range(y0, y1 + 1):
                for x in range(x0, x1 + 1):
                    counts[g // BLK, y * tiles_x + x] += 1
    return words.view(np.int32), counts


@pytest.mark.parametrize("n,w,h", [(1000, 256, 256), (500, 144, 96), (129, 48, 32)])
def test_count_pass_matches_brute_force(n, w, h):
    """Words and counts bitwise, with padding past n, invalid and off-grid
    splats, and a non-square grid."""
    (valid, *bnd), tiles_x, tiles_y = bounds(n, w, h, seed=n)
    assert not bool(valid[:4].any())  # the off-grid splats were culled
    words, counts = rc.bin_count_plain(valid, *bnd, tiles_x, tiles_y)
    want_words, want_counts = brute_force(valid.numpy(), *(b.numpy() for b in bnd), tiles_x,
                                          tiles_y)
    assert words.dtype == counts.dtype == torch.int32
    assert counts.shape == (-(-n // BLK), tiles_x * tiles_y)
    np.testing.assert_array_equal(words.numpy(), want_words)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert n % BLK and (words[n:] == np.int32(np.uint32(0xFF000000).view(np.int32))).all()


def planes(valid, tx0, tx1, ty0, ty1):
    """The reference's (4, 128, nb) bfloat16 byte planes
    (raster_tiled.py:172-185), built in numpy."""
    n = valid.shape[0]
    pad = -n % BLK

    def plane(a, pad_value):
        p = np.pad(np.where(valid, a, pad_value), (0, pad), constant_values=pad_value)
        return p.reshape(-1, BLK).T

    return jnp.asarray(np.stack([plane(tx0, 255.0), plane(tx1, 0.0), plane(ty0, 255.0),
                                 plane(ty1, 0.0)]), dtype=jnp.bfloat16)


@pytest.mark.parametrize("off", [0, 128])
def test_slot_pass_matches_pallas(off):
    """bin_slots_plain on the (nb, T) cumsum of the count pass against
    bin_slots_pallas (interpret mode) on the same cumsum and planes, k=128:
    ids and sentinels bitwise."""
    n, k = 600, 128
    (valid, *bnd), tiles_x, tiles_y = bounds(n, 64, 64, seed=7, skew=2.0)
    words, counts = rc.bin_count_plain(valid, *bnd, tiles_x, tiles_y)
    cum_t = torch.cumsum(counts, 0, dtype=torch.int32)
    got = rc.bin_slots_plain(cum_t, words, k, off, tiles_x, n)
    want = bin_slots_pallas(jnp.int32(off), jnp.asarray(cum_t.numpy()),
                            planes(valid.numpy(), *(b.numpy() for b in bnd)), k, tiles_x, BLK, n,
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got < n).sum()) and int((got == n).sum()) > 0  # filled slots and sentinels


@pytest.mark.parametrize("n,seed", [(100, 1), (2500, 2)])
@pytest.mark.parametrize("k", [128, 256, 1024])
def test_slot_pass_model_matches_plain(n, seed, k):
    """At offsets 0, 128 and 256, one block (nb = 1) and 20 blocks over a
    6x4 grid, denser toward one corner: every slot the model leaves
    unwritten is a sentinel, and the result is bin_slots_plain's bitwise.
    The 20-block scene has windows that start and end inside a block,
    tiles whose count is below the offset, and blocks with no member in the
    window."""
    (valid, *bnd), tiles_x, tiles_y = bounds(n, 96, 64, seed, spread=4.0, radius=(1.0, 12.0),
                                             skew=2.0)
    words, counts = rc.bin_count_plain(valid, *bnd, tiles_x, tiles_y)
    cum_t = torch.cumsum(counts, 0, dtype=torch.int32)
    lo = F.pad(cum_t, (0, 0, 1, 0))[:-1]
    for off in (0, 128, 256):
        got = smoke.slot_pass_model(torch, cum_t, words, k, off, tiles_x, n)
        assert not bool((got == -1).any())
        want = rc.bin_slots_plain(cum_t, words, k, off, tiles_x, n)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        if n > 1000 and off:
            # the smoke's planted faults of the slot pass change the ids
            for fault in smoke.BIN_SPLIT_FAULTS[2:]:
                bad = smoke.slot_pass_model(torch, cum_t, words, k, off, tiles_x, n, fault=fault)
                assert not torch.equal(bad, want), fault
            assert bool((cum_t[-1] < off).any())
            assert bool(((lo < off) & (cum_t > off)).any())  # a window starting inside a block
            if k == 128 and off == 128:  # and one ending inside a block
                assert bool(((lo < off + k) & (cum_t > off + k)).any())
            assert bool(((cum_t > lo) & ((cum_t <= off) | (lo >= off + k))).any())
    assert cum_t.shape[0] == -(-n // BLK)


def test_pass_wrappers_refuse_bad_inputs():
    valid = torch.ones(200, dtype=torch.bool)
    b = torch.zeros(200)
    with pytest.raises(ValueError, match="valid"):
        rc.bin_count(valid.to(torch.uint8), b, b, b, b, 4, 4)
    with pytest.raises(ValueError, match="bounds"):
        rc.bin_count(valid, b.double(), b, b, b, 4, 4)
    with pytest.raises(ValueError, match="bounds"):
        rc.bin_count(valid, b[:100], b, b, b, 4, 4)
    with pytest.raises(ValueError, match="tiles"):
        rc.bin_count(valid, b, b, b, b, 257, 4)  # a byte holds 256 tile columns
    big = torch.ones(rc.BIN_MAX_BLOCKS * BLK + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="blocks"):
        rc.bin_count(big, *(torch.zeros(big.shape[0]),) * 4, 4, 4)
    with pytest.raises(ValueError, match="cuda"):
        rc.bin_count(valid.to("meta"), *(b.to("meta"),) * 4, 4, 4)
    with pytest.raises(ValueError, match="(?i)cuda"):
        rc.bin_count_cuda(valid, b, b, b, b, 4, 4)
    cum_t = torch.zeros((2, 16), dtype=torch.int32)
    words = torch.zeros(2 * BLK, dtype=torch.int32)
    with pytest.raises(ValueError, match="cum_t"):
        rc.bin_slots_cuda(cum_t.T.contiguous(), words, 128, 0, 4, 200)
    with pytest.raises(ValueError, match="aabb"):
        rc.bin_slots_cuda(cum_t, words.long(), 128, 0, 4, 200)
    with pytest.raises(ValueError, match="(?i)cuda"):
        rc.bin_slots_cuda(cum_t, words, 128, 0, 4, 200)
