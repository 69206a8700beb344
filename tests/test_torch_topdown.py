"""The port's top-down queries against the JAX package on the same numpy
inputs: the dual CSR blend twin (the CPU path of kernel B5) against the
Pallas kernel in interpret mode, its bitwise identities, the band walk of
rasterize_tiled_exact, _topdown_dual on the full grid and on windows,
render_topdown, _changed_bbox and IncrementalTopdown.

Tolerances. The twin and the Pallas kernel sum the in-segment log prefix in
different orders (cumsum, Hillis-Steele): image 1e-4 absolute, logT 1e-5
relative and 1e-4 absolute, as for B3 (test_torch_csr.py); free alpha 1e-5.
The u8 maps are compared exactly: a pixel may differ only where its value
lies within 1e-5 of a binarization threshold (free alpha at 0.4, gray at
255), and these scenes hold none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activesplat_tpu.ops import raster_tiled as jtiled
from activesplat_tpu.ops.raster_pallas import blend_csr_dual_pallas
from activesplat_tpu.queries import topdown as jtd
from activesplat_tpu.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.convert import buffer_from_numpy
from activesplat_tpu_torch.ops import raster_cuda as rc
from activesplat_tpu_torch.ops import raster_tiled as ttiled
from activesplat_tpu_torch.queries import topdown as ttd
from activesplat_tpu_torch.utils import tracing
from tests.test_queries import buffer_from_points, world_topdown_cfg
from tests.test_torch_csr import N_TILES, SATURATING, SEGMENTS, make_stream
from tests.test_torch_exact import NAMES, REST, cluster_inputs
from tests.test_torch_raster import H, W, t

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG_FIELDS = ("height_axis", "world_dim_index", "world_2d_bbox", "grid_shape",
              "meter_per_pixel", "world_center", "agent_foot", "agent_head")


# --------------------------------------------------------------------------- #
# Kernel B5's twin
# --------------------------------------------------------------------------- #


def dual_stream(seed):
    """test_torch_csr's stream with band bits per tile: all set, sparse,
    none, and in the saturating tile none in its first segment (so the full
    composite saturates there while the band walks on) and all in its
    second."""
    rng = np.random.default_rng(seed)
    rows, seg_tile, seg_u0, seg_v0 = make_stream(rng)
    tile_of_row = np.repeat(seg_tile, rc.CSEG)
    first = np.concatenate([[0], np.cumsum(SEGMENTS)]) * rc.CSEG
    sparse = (rng.uniform(size=len(rows)) < 0.3).astype(np.float32)
    band = {0: 1.0, 1: sparse, 4: 1.0, 6: 0.0, 7: sparse}
    rows[:, rc.BAND_COL] = 0.0
    for tile, bits in band.items():
        sel = tile_of_row == tile
        rows[sel, rc.BAND_COL] = bits[sel] if isinstance(bits, np.ndarray) else bits
    rows[first[SATURATING] + rc.CSEG : first[SATURATING + 1], rc.BAND_COL] = 1.0
    return rows, seg_tile, seg_u0, seg_v0


def band_rows(rows):
    """The same rows with the opacity multiplied by the band bit."""
    out = rows.clone()
    out[:, 5] = out[:, 5] * out[:, rc.BAND_COL]
    return out


def test_dual_twin_matches_pallas():
    """Visited tiles' image, logT and band logT against the Pallas dual
    kernel (the JAX side leaves tiles with no segment unwritten: masked);
    empty tiles get zeros. The saturating tile's full logT keeps falling
    past LOG_EPS while its band walks on."""
    stream = dual_stream(40)
    ref = blend_csr_dual_pallas(*map(jnp.asarray, stream), N_TILES, n_channels=3, interpret=True)
    got = rc.blend_csr_dual_fwd(*(torch.from_numpy(x) for x in stream), N_TILES, 3)
    vis = np.array(SEGMENTS) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[vis], np.asarray(r)[vis], rtol=1e-5, atol=1e-4)
        assert np.all(g.numpy()[~vis] == 0)
    # the band's segment-start logT stays clear of LOG_EPS (where the two
    # sides could decide the exit differently within rounding)
    args = [torch.from_numpy(x) for x in stream]
    _, _, entry = rc.blend_csr_fwd(band_rows(args[0]), *args[1:], N_TILES, 3, with_entry=True)
    walked = stream[1] < N_TILES
    assert np.all(np.abs(entry.numpy()[walked].max(axis=1) - rc.LOG_EPS) > 0.05)
    logt, logt_band = got[1][SATURATING], got[2][SATURATING]
    assert logt.max() < rc.LOG_EPS - 1.0 and logt_band.max() < rc.LOG_EPS
    assert got[2][6].abs().max() == 0  # no band bit: the band stays transparent


def test_dual_twin_bitwise_identities():
    """The band carry is bitwise B3's logT over rows whose opacity is
    multiplied by the band bit; with every band bit set, (accum, logT) is
    bitwise B3's and the band carry equals the full one."""
    args = [torch.from_numpy(x) for x in dual_stream(41)]
    _, _, logt_band = rc.blend_csr_dual_fwd(*args, N_TILES, 3)
    _, logt_b3 = rc.blend_csr_fwd(band_rows(args[0]), *args[1:], N_TILES, 3)
    assert torch.equal(logt_band, logt_b3)
    ones = args[0].clone()
    ones[:, rc.BAND_COL] = 1.0
    accum, logt, logt_band = rc.blend_csr_dual_fwd(ones, *args[1:], N_TILES, 3)
    accum_b3, logt_b3 = rc.blend_csr_fwd(ones, *args[1:], N_TILES, 3)
    assert torch.equal(accum, accum_b3) and torch.equal(logt, logt_b3)
    assert torch.equal(logt_band, logt)


def test_rasterize_tiled_exact_band_matches_jax():
    """The band walk of the CSR rasterizer (C=3, half the Gaussians in the
    band) against JAX's."""
    d = cluster_inputs(42)
    d["colors"] = d["colors"][:, :3].copy()
    band = np.random.default_rng(43).uniform(size=len(d["depth"])) < 0.5
    ref = jtiled.rasterize_tiled_exact(
        *(jnp.asarray(d[k]) for k in NAMES + REST), jnp.asarray(band),
        width=W, height=H, interpret=True,
    )
    got = ttiled.rasterize_tiled_exact(*(t(d[k]) for k in NAMES + REST), t(band), width=W, height=H)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    for g, r in zip(got[1:3], ref[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    assert got[3] == int(ref[3]) == 0
    assert (got[2] > got[1]).any()  # the band composites fewer Gaussians


# --------------------------------------------------------------------------- #
# The top-down queries
# --------------------------------------------------------------------------- #


def port_buffer(jbuf):
    d = {k: np.asarray(getattr(jbuf.params, k)) for k in
         ("means3d", "rgb", "quats", "logit_opacities", "log_scales")}
    d["active"] = np.asarray(jbuf.active)
    for k in ("timestep", "max_radius", "grad_accum", "denom"):
        d[k] = np.zeros(jbuf.capacity, np.float32)
    return buffer_from_numpy(d, device="cpu")


def make_maps(seed=3, n=4000):
    """The scene of tests/test_topdown_incremental.py: (JAX config, JAX
    buffer, port config, port buffer)."""
    cfg = world_topdown_cfg(BoxWorld.single_room(seed=seed), pixel_max=96)
    jbuf = buffer_from_points(BoxWorld.single_room(seed=seed).sample_surface(n, seed=seed), scale=0.08)
    tcfg = ttd.TopdownConfig(**{f: getattr(cfg, f) for f in CFG_FIELDS})
    return cfg, jbuf, tcfg, port_buffer(jbuf)


def assert_maps_match(got_u8, ref_u8, free_alpha):
    """u8 maps equal except where the pixel's value lies within 1e-5 of a
    threshold; returns the count of such pixels that differ (0 here)."""
    differ = got_u8 != ref_u8
    near = np.zeros_like(differ)
    near[0] = np.abs(free_alpha - ttd.FREE_OPACITY_THRESHOLD) < 1e-5
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]
    return int((differ & near).sum())


@pytest.mark.parametrize("rect", [None, (0, 0, 48, 48), (16, 16, 48, 48), "far corner"])
def test_topdown_dual_matches_jax(rect):
    """_topdown_dual on the full grid and on three window rects: inside the
    window, the u8 maps equal JAX's and the full grid's; free alpha within
    1e-5."""
    cfg, jbuf, tcfg, tbuf = make_maps()
    if rect is None:
        rect = (0, 0, cfg.width, cfg.height)
    elif rect == "far corner":
        rect = (cfg.width - 48, cfg.height - 48, 48, 48)
    u0, v0, w, h = rect
    win = (slice(None), slice(v0, v0 + h), slice(u0, u0 + w))
    foot, head = cfg.agent_foot, cfg.agent_head
    ref_u8, ref_alpha = jtd._topdown_dual(
        jbuf, jtd.topdown_camera(cfg), jnp.float32(foot), jnp.float32(head),
        np.asarray(rect, np.int32), height_axis=cfg.height_axis, k_per_tile=256, backend="xla",
    )
    got_u8, got_alpha = ttd._topdown_dual(
        tbuf, ttd.topdown_camera(tcfg, device="cpu"), foot, head, rect,
        height_axis=tcfg.height_axis, k_per_tile=256,
    )
    got_alpha = got_alpha.numpy()[win[1:]]
    np.testing.assert_allclose(got_alpha, np.asarray(ref_alpha)[win[1:]], atol=1e-5)
    assert assert_maps_match(got_u8.numpy()[win], np.asarray(ref_u8)[win], got_alpha) == 0
    full_u8, _ = ttd._topdown_dual(
        tbuf, ttd.topdown_camera(tcfg, device="cpu"), foot, head, (0, 0, cfg.width, cfg.height),
        height_axis=tcfg.height_axis, k_per_tile=256,
    )
    np.testing.assert_array_equal(got_u8.numpy()[win], full_u8.numpy()[win])


def test_render_topdown_matches_jax_and_pair_oracle():
    """render_topdown against JAX's, and the dual maps against the port's
    own pair of exact renders (_topdown_binary, B3 twice)."""
    cfg, jbuf, tcfg, tbuf = make_maps()
    f_ref, u_ref, a_ref = jtd.render_topdown(jbuf, cfg, chunk=256)
    free, unobs, alpha = ttd.render_topdown(tbuf, tcfg)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(a_ref), atol=1e-5)
    near = assert_maps_match(np.stack([free, unobs]), np.stack([f_ref, u_ref]), alpha.numpy())
    assert near == 0
    assert 0 < free.mean() < 1 and 0 < unobs.mean() < 1
    pair, pair_alpha = ttd._topdown_binary(
        tbuf, ttd.topdown_camera(tcfg, device="cpu"), tcfg.agent_foot, tcfg.agent_head,
        height_axis=tcfg.height_axis, chunk=256, k_per_tile=256,
    )
    np.testing.assert_array_equal(pair.numpy(), np.stack([free, unobs]))
    np.testing.assert_allclose(pair_alpha.numpy(), alpha.numpy(), atol=1e-6)


def test_topdown_multipass_fallback(monkeypatch):
    """Past the entry budget the dual walk takes the bounded multipass pair
    (B1 twice, decided on the host): the maps equal the CSR walk's."""
    cfg, _, tcfg, tbuf = make_maps(n=1500)
    free, unobs, alpha = ttd.render_topdown(tbuf, tcfg)
    monkeypatch.setattr(ttiled, "_ENTRY_CAP", 1024)
    calls = []
    real = ttd.rasterize_tiled
    monkeypatch.setattr(ttd, "rasterize_tiled", lambda *a, **k: calls.append(1) or real(*a, **k))
    free_m, unobs_m, alpha_m = ttd.render_topdown(tbuf, tcfg)
    assert len(calls) == 2
    np.testing.assert_allclose(alpha_m.numpy(), alpha.numpy(), atol=1e-5)
    assert assert_maps_match(np.stack([free_m, unobs_m]), np.stack([free, unobs]), alpha.numpy()) == 0


def test_changed_bbox_matches_jax():
    _, jbuf, _, tbuf = make_maps(n=512)
    moved = np.asarray(jbuf.params.means3d).copy()
    moved[3] += [0.5, 0.0, 0.0]
    moved[7] += [0.0, 0.0, -0.3]
    active = np.asarray(jbuf.active).copy()
    active[11] = False
    active[-1] = True
    moved[-1] = [1.0, 0.5, 1.0]
    jbuf2 = jbuf.replace(params=jbuf.params.replace(means3d=jnp.asarray(moved)),
                         active=jnp.asarray(active))
    for a, b in ((jbuf, jbuf), (jbuf2, jbuf)):
        ref = np.asarray(jtd._changed_bbox(a.params, a.active, b.params, b.active, jnp.float32(0.01)))
        pa, pb = port_buffer(a), port_buffer(b)
        got = ttd._changed_bbox(pa.params, pa.active, pb.params, pb.active, 0.01).numpy()
        assert got[0] == ref[0]
        np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-6)  # exp: libm vs XLA
    assert ref[0] == 4


def test_incremental_topdown_matches_jax():
    """The refresh sequence of test_topdown_incremental.py on both sides:
    first (full), unchanged (clean), a 0.4 m ball moved (window), a global
    move (full), capacity growth (full); equal stats and maps, and each map
    equal to a fresh render_topdown. Then the port's snapshot is a copy: a
    buffer written in place after a refresh is not "clean"."""
    cfg, jbuf, tcfg, tbuf = make_maps()
    j_eng, t_eng = jtd.IncrementalTopdown(cfg), ttd.IncrementalTopdown(tcfg)
    means = np.asarray(jbuf.params.means3d)
    d = np.linalg.norm(means - means[0], axis=1)
    local = (d < 0.4) & np.asarray(jbuf.active)
    steps = [
        ("full_first", lambda m: m),
        ("clean", lambda m: m),
        ("window", lambda m: np.where(local[:, None], m + 0.05, m)),
        ("full_oversize", lambda m: m + 0.01),
    ]
    m = means
    for want, edit in steps:
        m = edit(m).astype(np.float32)
        jb = jbuf.replace(params=jbuf.params.replace(means3d=jnp.asarray(m)))
        tb = port_buffer(jb)
        ref = j_eng.refresh(jb)
        got = t_eng.refresh(tb)
        assert t_eng.stats == j_eng.stats and t_eng.stats[want] >= 1, (want, t_eng.stats)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        fresh = ttd.render_topdown(tb, tcfg)
        for g, f in zip(got, fresh):
            np.testing.assert_array_equal(g, f)
    grown = tb.grown(tb.capacity * 2)
    t_eng.refresh(grown)
    assert t_eng.stats["full_growth"] == 1 and t_eng.stats["full"] == 3

    # an in-place write after a refresh: the next refresh must see it
    ball = torch.from_numpy(local)
    grown.params.means3d[: len(ball)][ball] += 0.05
    f_w, u_w = t_eng.refresh(grown)
    assert t_eng.stats["window"] == 2 and t_eng.stats["clean"] == 1, t_eng.stats
    f_ref, u_ref, _ = ttd.render_topdown(grown, tcfg)
    np.testing.assert_array_equal(f_w, f_ref)
    np.testing.assert_array_equal(u_w, u_ref)


def test_tracing_counts_copies_per_stage():
    """stage() sums wall time per name (nested stages each count); fetch()
    counts device-to-host copies and bytes against the innermost stage."""
    tracing.reset_stages()
    with tracing.stage("outer"):
        with tracing.stage("inner"):
            a = tracing.fetch(torch.zeros((2, 3), dtype=torch.uint8))
        tracing.fetch(torch.ones(4))
    tracing.fetch(torch.ones(1))
    assert a.shape == (2, 3) and a.dtype == np.uint8
    report = tracing.stage_report()
    assert report["outer"][1] == report["inner"][1] == 1 and report["outer"][0] >= report["inner"][0]
    assert tracing.stage_report_io() == {
        "inner": {"fetch": 1, "fetch_bytes": 6},
        "outer": {"fetch": 1, "fetch_bytes": 16},
        "(no stage)": {"fetch": 1, "fetch_bytes": 4},
    }
    assert "inner" in tracing.format_stage_report()
    tracing.reset_stages()
    assert tracing.stage_report() == {} and tracing.format_stage_report() == "no stages recorded"
