#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from activesplat_tpu_torch/csrc; print the card;
  2. hold each tile-blend kernel against its plain PyTorch twin on random
     tile rows (T=256, K=256, C=5, with empty, saturating and padded tiles),
     and check that the comparison rejects planted faults;
  3. drive the mapping slice at the benchmark's size (200,000 Gaussians in
     a 262,144-slot buffer, 256x256 sensor, k_per_tile=256,
     exact_training="off"): first_frame_phase, three mapping_phase events of
     10 iterations, one warm-up mapping_iteration and 30 timed ones. The
     launch counters are set to 0 just before each of these phases and read
     just after it; each event must launch each kernel 10 times and the timed
     run 30 times. Then run 20 more iterations under torch.profiler and
     print the device's busy time and idle share per iteration and the
     operators that take the most device and host time. Then check the port
     on the card against the port on the CPU on a small scene;
  4. time each kernel, its twin and its bound on the main path's own tile
     rows, and print one {"kernels": [...]} line;
  5. print the device line last.

It needs one CUDA card and exits non-zero without one, or without the rest of
the repository beside it.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_GAUSSIANS = 200_000
RES = 256
K_PER_TILE = 256
N_CHANNELS = 5
EVENTS = 3
EVENT_ITERS = 10
TIMED_ITERS = 30
PROFILE_ITERS = 20

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 bandwidth,
# float32 outside the tensor cores, and 16 special-function results per
# clock per SM (times the card's maximum SM clock, read from nvidia-smi)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM = 16

# Work the blend needs, counted from its mathematics at C channels (an FMA
# counts as two float32 operations, a division as one; comparisons and
# selects are not counted). Every (row, pixel) pair of a walked segment needs
# its power: dx, dy and the quadratic form, 11 operations. Only a pair whose
# alpha is not zero ("live") needs more; telling which pairs are live needs
# no exp, since op e^power >= 1/255 is power >= -log(255 op), one log per row.
# A live pair needs three special-function results in either direction: exp
# of the power, log1p(-alpha), and exp of the logT before it.
WALKED_F32 = 11
LIVE_SFU = 3


def live_f32_fwd(c: int) -> int:
    # op e^power, the logT add, w, the log-prefix update; w col (C FMAs)
    return 4 + 2 * c


def live_f32_bwd(c: int) -> int:
    # op e^power (1), the prefix and logT adds (2), w (1), 1 - alpha (1),
    # d_alpha (4), the suffix update (FMA, 2), d_power (1), the six geometric
    # gradients (14) and one add each to sum them over the pixels (6);
    # col . g (C FMAs), the C colour gradients and their pixel sums
    return 32 + 4 * c


# Tolerances of a kernel against its twin (kernel_checks says why)
REL_TOL = 1e-5  # of each output column's largest value, and of |logT|
LOGT_ATOL = 1e-4
BOUNDARY = 1e-3  # a segment-start max logT this close to LOG_EPS may skip on one side only
SKIP_ATOL = 5e-3  # > exp(LOG_EPS): the most a skipped segment moves a value

FWD_REPLACES = "activesplat_tpu/ops/raster_pallas.py:296 (_blend_fwd_pallas / _blend_kernel :52)"
BWD_REPLACES = "activesplat_tpu/ops/raster_pallas.py:239 (_blend_bwd_pallas / _blend_bwd_kernel :123)"


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_tiles(torch, seed: int, t: int = 256, k: int = 256):
    """Tile rows at the main path's shape with the edge cases mixed in:
    tiles 0-15 empty (all padding rows), 16-79 saturating (large, opaque
    Gaussians), the rest with lists of random length (padded to K)."""
    from activesplat_tpu_torch.ops.raster_cuda import N_ATTR, TILE

    g = torch.Generator(device="cpu").manual_seed(seed)
    tiles_x = 16
    ids = torch.arange(t, dtype=torch.int32)
    u0 = (ids % tiles_x) * TILE
    v0 = torch.div(ids, tiles_x, rounding_mode="floor") * TILE

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    rows = torch.zeros((t, k, N_ATTR))
    rows[:, :, 0] = u0[:, None] + unif(-8, 24, t, k)
    rows[:, :, 1] = v0[:, None] + unif(-8, 24, t, k)
    rows[:, :, 2] = unif(0.02, 0.6, t, k)
    rows[:, :, 3] = unif(-0.02, 0.02, t, k)
    rows[:, :, 4] = unif(0.02, 0.6, t, k)
    rows[:, :, 5] = unif(0.05, 0.9, t, k)
    rows[:, :, 6:6 + N_CHANNELS] = unif(0, 1, t, k, N_CHANNELS)
    sat = slice(16, 80)
    rows[sat, :, 2] = unif(0.001, 0.01, 64, k)
    rows[sat, :, 3] = 0.0
    rows[sat, :, 4] = unif(0.001, 0.01, 64, k)
    rows[sat, :, 5] = unif(0.9, 0.99, 64, k)
    lengths = torch.randint(1, k + 1, (t,), generator=g)
    lengths[:16] = 0
    lengths[16:80] = k
    pad = torch.arange(k)[None, :] >= lengths[:, None]
    pad_row = torch.tensor([-1e9, -1e9, 1.0, 1.0, 1.0] + [0.0] * (N_ATTR - 5))
    rows[pad] = pad_row
    return rows.cuda(), u0.cuda(), v0.cuda()


def check_close(name, got, want, limit) -> float:
    """Fail unless `got` is finite and within `limit` (broadcast) of `want`
    everywhere; return the largest share of its limit that an error used."""
    import torch

    err = (got - want).abs()
    bad = ~torch.isfinite(got) | (err > limit)
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values over tolerance, "
            f"max abs err {float(err.max()):.3e}"
        )
    return float((err / torch.clamp(limit, min=1e-30)).max()) if err.numel() else 0.0


def must_reject(name, check) -> None:
    try:
        check()
    except AssertionError:
        return
    raise AssertionError(f"the comparison missed a planted fault: {name}")


def kernel_checks(torch, rc, rows, u0, v0, tag: str):
    """Each kernel against its twin on the same inputs.

    Tolerances. Both sides compute the same float32 terms; they differ in
    the order of the sums (sequential in-segment log prefix and warp-shuffle
    pixel sums in the kernels, cumsum and sum in the twins), so each output
    column agrees to REL_TOL of its largest value, and logT and the entry
    stash agree in the log domain to LOGT_ATOL + REL_TOL |logT| (a sum of up
    to K log terms). One exception: a tile whose max logT at a segment start
    lies within BOUNDARY of LOG_EPS may be skipped by one side and walked by
    the other, which moves a value by at most the transmittance left,
    exp(-5.55) < SKIP_ATOL, as tests/test_pallas.py:53-55 documents for the
    reference; such tiles are compared in the transmittance domain at
    SKIP_ATOL. The backward is given the kernel's own stash on both sides,
    so it has no such exception.
    """
    c = N_CHANNELS
    shares = {}
    acc_k, lt_k, ent_k = rc.blend_tiles_fwd(rows, u0, v0, c, with_entry=True)
    acc_p, lt_p, ent_p = rc.blend_tiles_fwd_plain(rows, u0, v0, c, with_entry=True)
    near = ((torch.stack([ent_k, ent_p]).amax(dim=3) - rc.LOG_EPS).abs() < BOUNDARY).any(dim=(0, 2))
    strict = ~near

    def fwd_shares(acc, lt, ent):
        chan = acc_p.abs().amax(dim=(0, 1))
        acc_lim = (REL_TOL + (SKIP_ATOL - REL_TOL) * near.float())[:, None, None] * chan
        out = [check_close(f"{tag} fwd accum", acc, acc_p, acc_lim)]
        for what, got, want in (("logT", lt, lt_p), ("entry", ent, ent_p)):
            got_s, want_s = got[strict], want[strict]
            out.append(check_close(f"{tag} fwd {what}", got_s, want_s,
                                   LOGT_ATOL + REL_TOL * want_s.abs()))
            out.append(check_close(f"{tag} fwd {what} (boundary tiles)", got[near].exp(),
                                   want[near].exp(), torch.tensor(SKIP_ATOL)))
        return max(out)

    shares["fwd"] = fwd_shares(acc_k, lt_k, ent_k)
    acc_n, lt_n = rc.blend_tiles_fwd(rows, u0, v0, c)
    if not (torch.equal(acc_n, acc_k) and torch.equal(lt_n, lt_k)):
        raise AssertionError(f"{tag}: the forward with and without the stash differ")
    deep = ent_k < rc.LOG_EPS - 2.0
    if bool(deep[strict].any()):
        must_reject("entry shifted by -1 below LOG_EPS - 2",
                    lambda: fwd_shares(acc_k, lt_k, torch.where(deep, ent_k - 1.0, ent_k)))
    must_reject("logT scaled by 1.001",
                lambda: fwd_shares(acc_k, lt_k * 1.001 + 1e-3, ent_k))

    g = torch.Generator(device="cuda").manual_seed(1)
    g_acc = torch.randn(acc_k.shape, generator=g, device="cuda")
    g_lt = torch.randn(lt_k.shape, generator=g, device="cuda")
    d_k = rc.blend_tiles_bwd(rows, u0, v0, ent_k, g_acc, g_lt, c)
    d_p = rc.blend_tiles_bwd_plain(rows, u0, v0, ent_k, g_acc, g_lt, c)
    col_max = d_p.abs().amax(dim=(0, 1))  # (16,)
    d_lim = REL_TOL * col_max

    def bwd_share(d):
        return check_close(f"{tag} bwd", d, d_p, d_lim)

    shares["bwd"] = bwd_share(d_k)
    per_col = (d_k - d_p).abs().amax(dim=(0, 1)) / torch.clamp(col_max, min=1e-30)
    for col in range(6 + c):
        zeroed = d_k.clone()
        zeroed[..., col] = 0.0
        must_reject(f"gradient column {col} zeroed", lambda: bwd_share(zeroed))
    rolled = d_k.clone()
    rolled[..., 6] = d_k[..., 6].roll(1, dims=0)
    must_reject("gradient column 6 moved one tile over", lambda: bwd_share(rolled))

    errs = {
        "fwd": max(float((acc_k - acc_p).abs().max()),
                   float((lt_k[strict] - lt_p[strict]).abs().max()),
                   float((ent_k[strict] - ent_p[strict]).abs().max())),
        "bwd": float((d_k - d_p).abs().max()),
    }
    print(f"{tag}: {int(near.sum())} boundary tiles; blend_tiles_fwd max_abs_err={errs['fwd']:.3e} "
          f"({shares['fwd']:.3f} of tolerance), blend_tiles_bwd max_abs_err={errs['bwd']:.3e} "
          f"({shares['bwd']:.3f} of tolerance); bwd max err per column / column max: "
          + " ".join(f"{float(x):.1e}" for x in per_col[:6 + c]))
    return errs, (ent_k, g_acc, g_lt)


def main_path_rows(torch, buf, cam):
    """The blend kernels' inputs for one training render of the map."""
    from activesplat_tpu_torch.ops.projection import adaptive_cull_radius, project_gaussians
    from activesplat_tpu_torch.ops.raster_tiled import tile_rows

    p = buf.params
    with torch.no_grad():
        proj = project_gaussians(
            p.means3d, p.quats, p.log_scales, buf.active, cam.w2c,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        )
        opac = torch.sigmoid(p.logit_opacities)
        radius, valid = adaptive_cull_radius(proj.radius, proj.valid, opac)
        colors = torch.cat([p.rgb, proj.depth[:, None], (proj.depth ** 2)[:, None]], -1)
        rows, u0, v0, _ = tile_rows(
            proj.mean2d, proj.conic, opac, colors, valid, radius, proj.depth,
            width=cam.width, height=cam.height, k_per_tile=K_PER_TILE,
        )
    return rows.contiguous(), u0, v0


def pair_counts(torch, rc, rows, u0, v0, entry):
    """(walked, live): the (row, pixel) pairs of the segments the forward
    walks, and those among them whose alpha is not zero."""
    walked_seg = entry.amax(dim=2) >= rc.LOG_EPS  # (T, K/SEG)
    px, py = rc._pixel_coords(u0, v0)
    live = 0
    for s in range(walked_seg.shape[1]):
        block = rows[:, s * rc.SEG:(s + 1) * rc.SEG]
        live_s = rc._segment_geometry(block, px, py)[5]  # (T, SEG, PX)
        live += int((live_s & walked_seg[:, s, None, None]).sum())
    return int(walked_seg.sum()) * rc.SEG * rc.PX, live


def small_scene_check(torch, np):
    """The port on the card against the port on the CPU (plain twins): loss
    and gradients of mapping_loss on a small random scene. Tolerance: the
    two differ in summation order only (and the SSIM matmuls' blocking), so
    1e-4 relative to each gradient's scale."""
    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.mapper.step import loss_and_grads
    from activesplat_tpu_torch.models.gaussians import GaussianBuffer, GaussianParams, make_camera

    rng = np.random.default_rng(7)
    n, w, h = 400, 64, 48
    d = {
        "means3d": np.concatenate(
            [rng.uniform(-1.2, 1.2, (n, 2)), rng.uniform(2.0, 5.0, (n, 1))], 1
        ),
        "rgb": rng.uniform(0, 1, (n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "logit_opacities": rng.uniform(-3.0, -1.0, n),
        "log_scales": rng.uniform(np.log(0.02), np.log(0.08), (n, 3)),
    }
    im = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    dep = rng.uniform(2.0, 5.0, (h, w)).astype(np.float32)
    intr = np.array([[40.0, 0, w / 2 - 1], [0, 40.0, h / 2 - 1], [0, 0, 1]])
    cfg = MapperConfig(k_per_tile=64, exact_training="off")
    results = []
    for dev in ("cpu", "cuda"):
        buf = GaussianBuffer.empty(512, device=dev)
        params = GaussianParams(
            *(torch.from_numpy(np.asarray(d[f], np.float32)).to(dev) for f in
              ("means3d", "rgb", "quats", "logit_opacities", "log_scales"))
        )
        pad = buf.params
        params = params.map(lambda a, b: torch.cat([a, b[n:]], 0), pad)
        active = torch.zeros(512, dtype=torch.bool, device=dev)
        active[:n] = True
        buf = buf.replace(params=params, active=active)
        cam = make_camera(w, h, intr, np.eye(4), device=dev)
        loss, aux, grads = loss_and_grads(
            buf, cam, torch.from_numpy(im).to(dev), torch.from_numpy(dep).to(dev), cfg
        )
        results.append((loss.cpu(), [g.cpu() for g in grads.tensors()]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    if not math.isfinite(float(l_gpu)) or abs(float(l_gpu) - float(l_cpu)) > 1e-5 * abs(float(l_cpu)) + 1e-6:
        raise AssertionError(f"small scene loss: cuda {float(l_gpu)} vs cpu {float(l_cpu)}")
    worst = 0.0
    for a, b in zip(g_gpu, g_cpu):
        scale = float(b.abs().max()) + 1e-12
        err = float((a - b).abs().max()) / scale
        worst = max(worst, err)
    if worst > 1e-4:
        raise AssertionError(f"small scene gradients differ: {worst:.3e} of scale")
    print(f"small scene: loss cuda {float(l_gpu):.7f} cpu {float(l_cpu):.7f}, "
          f"max grad err {worst:.3e} of scale")


def profile_iterations(torch, step, iters: int, timed_ms: float, card: str) -> None:
    """Run `iters` chained steps under torch.profiler; print the device's
    busy time and idle share per iteration and the top operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            m = step()
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters
    print(f"profile of {iters} mapping_iterations on {card}: wall {wall_ms:.3f} ms/iter "
          f"under the profiler ({timed_ms:.3f} without), device busy {busy_ms:.3f} ms/iter "
          f"in {len(kernels) / iters:.0f} kernels/iter, idle share {1.0 - busy_ms / wall_ms:.3f} "
          f"of the profiled wall time, {1.0 - busy_ms / timed_ms:.3f} of the unprofiled one")
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=20))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=20))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from activesplat_tpu_torch import _build
        from activesplat_tpu_torch.ops import raster_cuda as rc
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2
    import numpy as np

    t_start = time.perf_counter()
    # ---- phase 1: build, card ------------------------------------------ #
    card = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in sorted(paths.items()):
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    print(card)  # name, power limit as nvidia-smi reports them
    print(f"max SM clock {max_sm_mhz:.0f} MHz")
    sfu_rate = SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_mhz * 1e6

    # ---- phase 2: kernels against their twins -------------------------- #
    rows, u0, v0 = random_tiles(torch, seed=0)
    errs, _ = kernel_checks(torch, rc, rows, u0, v0, "random tiles T=256 K=256")
    rows_p, u0_p, v0_p = random_tiles(torch, seed=1, k=192)  # K not a SEG multiple...
    rows_p = torch.nn.functional.pad(rows_p, (0, 0, 0, 64))  # ...padded to 256
    rows_p[:, 192:, 0:2] = -1e9
    rows_p[:, 192:, 2:5] = 1.0
    errs_p, _ = kernel_checks(torch, rc, rows_p.contiguous(), u0_p, v0_p, "padded K=192->256")
    for k in errs:
        errs[k] = max(errs[k], errs_p[k])
    torch.cuda.synchronize()

    # ---- phase 3: the mapping slice at the benchmark's size ------------ #
    from activesplat_tpu_torch.mapper.adam import AdamState
    from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
    from activesplat_tpu_torch.mapper.step import (
        first_frame_phase,
        mapping_iteration,
        mapping_phase,
    )
    from activesplat_tpu_torch.models.gaussians import GaussianBuffer
    from activesplat_tpu_torch.runtime.bench_scene import build_map
    from activesplat_tpu_torch.utils.transforms import rot_axis

    scene = build_map(N_GAUSSIANS, RES, k_per_tile=K_PER_TILE)
    buf, cam, cfg, c2w0 = scene.buf, scene.cam, scene.cfg, scene.c2w
    rgb0, depth0 = scene.frame(c2w0)

    by_phase = {}  # phase -> {kernel: launches}, counters set to 0 before each

    def read_counts(phase, expect=None):
        counts = {fn.__name__: fn.launches for fn in rc.KERNELS}
        rc.reset_launch_counts()
        by_phase[phase] = counts
        if expect is not None and set(counts.values()) != {expect}:
            raise AssertionError(f"{phase}: blend launches {counts}, not {expect} each")
        return counts

    rc.reset_launch_counts()
    fresh = GaussianBuffer.empty(1 << 17)
    fresh, n_drop, scene_radius = first_frame_phase(fresh, cam, rgb0, depth0, cfg)
    read_counts("first_frame_phase")
    n_init = int(fresh.num_active())
    if n_init != int((depth0 > 0).sum()) or int(n_drop) != 0:
        raise AssertionError(f"first_frame_phase inserted {n_init}, dropped {int(n_drop)}")
    print(f"first_frame_phase: {n_init} Gaussians, scene radius {float(scene_radius):.3f} m")

    store = KeyframeStore.empty(16, RES, RES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for ev in range(EVENTS):
        c2w = rot_axis(c2w0, "y", np.deg2rad(4.0 * ev))
        c2w[:3, 3] += [0.05 * ev, 0.0, 0.0]
        rgb, depth = scene.frame(c2w)
        w2c = torch.from_numpy(np.linalg.inv(c2w).astype(np.float32)).cuda()
        rc.reset_launch_counts()
        buf, store, met = mapping_phase(
            buf, store, rgb, depth, w2c, ev, cam, gen, cfg, EVENT_ITERS
        )
        counts = read_counts(f"mapping_phase {ev}", EVENT_ITERS)
        store.committed(rgb, depth, w2c, ev)
        losses = met["loss"].cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError(f"event {ev}: non-finite losses {losses}")
        print(f"mapping_phase {ev}: losses {losses[0]:.5f} -> {losses[-1]:.5f}, "
              f"psnr {float(met['psnr'][-1]):.3f}, dropped {int(met['dropped'].max())}, "
              f"window {int(met['num_window'])}, launches {counts}")

    opt = AdamState.init(buf.params)
    rc.reset_launch_counts()
    buf, opt, m = mapping_iteration(buf, opt, cam, rgb0, depth0, cfg)
    read_counts("warm-up", 1)
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    t0 = time.perf_counter()
    acc = torch.zeros((), device="cuda")
    for _ in range(TIMED_ITERS):
        buf, opt, m = mapping_iteration(buf, opt, cam, rgb0, depth0, cfg)
        acc = acc + m["loss"] + 1e-20 * (m["psnr"] + m["depth_l1"])
    final = float(acc)  # synchronises and reads the chain's value
    dt = time.perf_counter() - t0
    read_counts("timed", TIMED_ITERS)
    if not math.isfinite(final):
        raise AssertionError("timed iterations produced a non-finite loss")
    launches = {fn.__name__: sum(c[fn.__name__] for c in by_phase.values()) for fn in rc.KERNELS}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    its = TIMED_ITERS / dt
    print(f"mapping_iters_per_sec@{N_GAUSSIANS}g_{RES}px = {its:.3f} "
          f"({1000.0 / its:.3f} ms/iter, {TIMED_ITERS} iterations, loss "
          f"{float(m['loss']):.5f}, dropped {int(m['dropped'])}) on {card}")
    print(f"main-path launches by phase: {by_phase}")

    state = [buf, opt]

    def step():
        state[0], state[1], out = mapping_iteration(state[0], state[1], cam, rgb0, depth0, cfg)
        return out

    profile_iterations(torch, step, PROFILE_ITERS, 1000.0 / its, card)
    buf = state[0]

    small_scene_check(torch, np)

    # ---- phase 4: kernels at the main path's rows ---------------------- #
    rows, u0, v0 = main_path_rows(torch, buf, cam)
    t, k, _ = rows.shape
    errs_m, (entry, g_acc, g_lt) = kernel_checks(torch, rc, rows, u0, v0, f"main-path rows T={t} K={k}")
    walked, live = pair_counts(torch, rc, rows, u0, v0, entry)
    n_walked_seg = walked // (rc.SEG * rc.PX)
    seg_bytes = rc.SEG * rc.N_ATTR * 4
    px_bytes = t * rc.PX * 4
    fwd_bytes = n_walked_seg * seg_bytes + 2 * t * 4 + px_bytes * (N_CHANNELS + 1 + k // rc.SEG)
    bwd_bytes = n_walked_seg * seg_bytes + 2 * t * 4 + px_bytes * (k // rc.SEG + N_CHANNELS + 1) + t * k * rc.N_ATTR * 4
    fwd_ms = cuda_ms(lambda: rc.blend_tiles_fwd(rows, u0, v0, N_CHANNELS, with_entry=True), 100)
    fwd_plain_ms = cuda_ms(lambda: rc.blend_tiles_fwd_plain(rows, u0, v0, N_CHANNELS, with_entry=True), 10)
    bwd_ms = cuda_ms(lambda: rc.blend_tiles_bwd(rows, u0, v0, entry, g_acc, g_lt, N_CHANNELS), 100)
    bwd_plain_ms = cuda_ms(lambda: rc.blend_tiles_bwd_plain(rows, u0, v0, entry, g_acc, g_lt, N_CHANNELS), 10)

    def bound(nbytes, live_f32):
        f32_ops = walked * WALKED_F32 + live * live_f32
        times = {
            "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": max(f32_ops / F32_FLOPS, live * LIVE_SFU / sfu_rate) * 1e3,
        }
        by = max(times, key=times.get)
        return times[by], by

    print(f"main-path rows: {n_walked_seg} of {t * (k // rc.SEG)} segments walked, "
          f"{walked} (row, pixel) pairs walked, {live} of them live ({live / walked:.4f})")
    kernels = []
    for name, src, repl, ms, plain_ms, (b_ms, b_by), err in (
        ("blend_tiles_fwd", "activesplat_tpu_torch/csrc/blend_fwd.cu", FWD_REPLACES,
         fwd_ms, fwd_plain_ms, bound(fwd_bytes, live_f32_fwd(N_CHANNELS)),
         max(errs["fwd"], errs_m["fwd"])),
        ("blend_tiles_bwd", "activesplat_tpu_torch/csrc/blend_bwd.cu", BWD_REPLACES,
         bwd_ms, bwd_plain_ms, bound(bwd_bytes, live_f32_bwd(N_CHANNELS)),
         max(errs["bwd"], errs_m["bwd"])),
    ):
        phases = {phase: c[name] for phase, c in by_phase.items()}
        print(f"{name}: max_abs_err={err:.3e} kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.3f} of it reached), "
              f"launches {launches[name]} {phases} on {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "launches_by_phase": phases,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    torch.cuda.synchronize()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
