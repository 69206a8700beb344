#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's kernels on one NVIDIA GPU.

    python3 chip_smoke.py

It checks on the card what neither the benchmark's cells nor the CPU tests
check: each hand-written kernel against its plain PyTorch twin, and the port
on the card against the port on the CPU. Phases, each fatal on failure:
  1. build the CUDA kernels from activesplat_tpu_torch/csrc; print the card
     and B1's, B2's and B4's two kernels' registers, shared memory and
     resident blocks;
  2. hold each blend kernel against its plain PyTorch twin: the tile blend
     (B1, B2) on random tile rows (T=256, K=256 and K=1,024, C=5, with
     empty, saturating and padded tiles), the CSR blend (B3, B4) on a random
     CSR stream (tiles with no, one and many segments, saturating tiles,
     padding segments), and check that the comparisons reject planted
     faults; the dual CSR blend (B5) on a random CSR stream with band bits
     (bands all set, none and sparse, tiles whose full composite saturates
     a segment before the band), with its two bitwise identities to B3; the
     bin kernel route (B6: the count pass, torch.cumsum, the slot pass) on
     the passes that bin_gaussians' kernel route hands its wrappers (the two
     scenes of tests/test_raster_tiled.py:324-332 at k=128 and 256, and a
     scene of 4,090 blocks of 128 splats, near the route's gate, each at
     slot offsets 0, 128 and 256): each pass bitwise against its plain
     version (bin_split_checks: the count pass's words and counts, the slot
     pass fed their cumsum against bin_slots_plain and against a torch model
     of its algorithm, both passes repeated), the route's lists bitwise
     against the sort route's, and planted faults rejected (of the output:
     the slot off by one, the members before a slot counted from its own
     block, the sentinel replaced by the window's last member; of the
     passes: a rectangle counted one tile wider, padding words counted as
     members, members ranked from the last lane down, the window test
     dropping the block where the window starts);
     B3 and B5 run as two passes (each segment alone, then a per-tile
     combine): on every CSR stream checked here and in phase 3, each pass is
     held against its plain version (split_checks: pass 1 into a NaN-filled
     scratch with the dead-pair audit, which must count 0 live pairs
     killed; the combine fed the kernel's own partials gives the plain
     combine's logT and stash bitwise; the wrapper equals its two passes
     bitwise), and planted faults (the combine reading its partials one
     segment off, the exit tested after accumulating, the dead-pair margin's
     sign flipped) are rejected;
     B1 runs as two passes from one C call (each tile segment composited
     alone from transmittance 1, blocks in rank-major order, then the
     per-tile combine): on every set of tile rows checked here and in phase
     3, each pass is held against its plain version (tile_fwd_split_checks:
     pass 1 into a NaN-filled scratch with the dead-pair and reach-mask
     audit, 0 live pairs killed, every walked segment computed; the combine
     fed the kernel's partials gives the plain combine's logT and stash
     bitwise; the wrapper equal to its passes bitwise and repeatable), and
     planted faults (a per-segment exit, two segments' partials swapped, a
     warp dropped from the reach masks, a stash written only for walked
     segments, the dead-pair margin's sign flipped) are rejected;
     B2 runs as two passes (each segment's suffix total, then the walk from
     the fold of the later totals): on every set of tile rows checked here
     and in phase 3, each pass is held against its plain version
     (tile_bwd_split_checks: pass 1 into a NaN-filled scratch with the
     dead-pair audit, 0 live pairs killed, exact zeros for skipped segments;
     pass 2 fed the kernel's totals against the plain walk fed the same; the
     wrapper equal to its passes bitwise and repeatable), and planted faults
     (the totals shifted one segment either way, the dead-pair margin's sign
     flipped) are rejected;
     B4 runs as two passes over the four 64-row pieces of each 256-row
     segment (each piece's log step and total from transmittance 1, then the
     walk from the fold of the tile's later totals): on every CSR stream it
     is checked on, each pass is held against its plain version
     (csr_bwd_split_checks: pass 1 into a NaN-filled scratch with the audit,
     0 live pairs killed, exact zeros on skipped and padding segments; the
     walk fed the kernel's piece totals against the plain walk fed the same;
     the wrapper equal to its passes bitwise and repeatable), and planted
     faults (the piece totals shifted one piece either way, a piece skipped
     by its own entry logT, the dead-pair margin's sign flipped) are
     rejected;
     the row gathers' backward (gather_rows_bwd, csrc/gather_bwd.cu) on a
     capped call at 512x512 (1,024 tiles x 1,024 rows, a fifth of them the
     padding row, into a 2.1M-row table, the gradient the 11 live columns
     of 16-wide rows) and on a CSR stream: rows below the padding row
     bitwise equal to the library's `_index_put_impl_`, the padding row
     zero, a second call bitwise equal to the first; the kernel's and the
     wrapper's ms beside its bound and the library's ms;
  3. each kernel on the main path's own inputs, held against its twin as in
     phase 2, timed and bounded (`measure`, `bound`). At 256x256 on
     runtime/bench_scene.py's maps: B1 and B2 on the tile rows of a k-capped
     render of the 200,000-Gaussian map (k=256), B3 and B4 on the CSR stream
     of its exact render, B6 on the render's bin (its visible prefix, k=256,
     slot offsets 0 and 256); B5 on the CSR stream of render_topdown and B3
     on the panorama view with the most walked pairs of one
     global_invisibility call (two nodes at scale 0.5), both on the
     1,000,000-Gaussian query map. One render(exact=True) of the 200,000
     map must launch B3 once without the stash and give the image of the
     exact_training="on" render's forward;
  4. the multi-device path (parallel/sharded.py) on a virtual mesh that
     names the card MESH_SHARDS=4 times (64 rows a shard at 256x256; over
     several cards the sharded render is also held against the unsharded
     one on the real devices, a branch that says so where it does not run),
     against the unsharded path on phase 3's maps: render_sharded_tiled
     against render (B1 four times; `dropped` the sum of the shards' own),
     sharded_mapping_loss's value and gradients against mapping_loss for
     "off" (k=256: B1 and B2 four times), "on" (k=256: B3 and B4 four times)
     and "hybrid" at k=64 (the mesh trains it as "on"; unsharded, its
     harmful tiles run all four blends once); one mapping_phase
     event of 10 iterations with mesh= against the unsharded event (the
     same store and draws; B1 and B2 40 times against 10): the first
     iteration's gradients and metrics tight, every iteration's metrics
     within MESH_METRIC_RTOL; the driver (SplaTAMMapper, MapperConfig())
     over MESH_FRAMES frames with the mesh against the unsharded driver: the
     Gaussian count equal, the last metrics within MESH_METRIC_RTOL;
     global_invisibility and local_invisibility on the query map with the
     views sharded, equal to the unsharded queries bitwise. Every launch
     count asserted, with one gather backward for each blend backward;
  5. each kernel at 512x512 (1,024 tiles, k=1,024), as in phase 3, on a map
     that the mapper driver builds from MAP_FRAMES frames of
     gibson_high_resolution's configuration in BoxWorld.single_room(87): B1
     and B2 on the rows of a k-capped render, B3 and B4 on the stream of an
     exact render, B5 on render_topdown's stream, B6 on the render's bin.
     The two renders' bins (256x256 and 512x512) are saved in build/ for
     scripts/bin_route_trace.py;
  6. the port on the card against the port on the CPU on small inputs:
     mapping_loss and its gradients on a small scene with exact_training
     "off", "on" and "hybrid" (small_scene_check); render_topdown and
     render_panorama (small_query_check); the mapper driver over five 64x64
     frames (small_driver_check); tests/test_torch_episode.py's parity
     episode, fatal unless the CPU run reaches its first target and the
     card's actions equal the CPU's through that arrival
     (small_episode_check); the judges over that episode's dump and
     fit_offline (small_judges_check); LPIPS(alex) on seeded weights
     (lpips_check); the Habitat adapter's mock episode
     (habitat_small_check); and one 512x512 frame of the native raycaster
     against the numpy one on the host (native_raycast_check);
  7. print each kernel's line and one {"kernels": [...]} line (B3 twice at
     256x256: the training stream and the panorama view), one
     {"gather_bwd": ...} line, then the device line last.

A kernel's "ms" is its own device time (torch.profiler, kernel_device_ms;
B1-B6: both passes summed, each in "pass_ms"), "wrapper_ms" the wrapper's
time per call of 100 back-to-back calls between CUDA events (which holds
the wrapper's helper kernels and, where the host is slower than the device,
its Python), "plain_ms" the twin's, "bound_ms" the least time the card could
take on these inputs (`bound`, `bin_bound`).

It needs one CUDA card and exits non-zero without one, or without the rest of
the repository beside it.
"""

import contextlib
import dataclasses
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
HYBRID_K = 64  # a k at which the map has harmful tiles in every iteration

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
# a segment's log step summed in two orders (sequential, cumsum): the
# worst-case float32 rounding of a 256-term sum of same-sign terms, per side
STEP_RTOL = 2 * 256 * 2.0 ** -24
# a pair whose raw alpha lies this close (relative) to ALPHA_MIN may be live
# on one side only: the kernels contract the power's products into FMAs,
# the plain versions round each one (a few ulps of the power)
EDGE_RTOL = 1e-4

FWD_REPLACES = "activesplat_tpu/ops/raster_pallas.py:296 (_blend_fwd_pallas / _blend_kernel :52)"
BWD_REPLACES = "activesplat_tpu/ops/raster_pallas.py:239 (_blend_bwd_pallas / _blend_bwd_kernel :123)"
CSR_FWD_REPLACES = ("activesplat_tpu/ops/raster_pallas.py:436 "
                    "(_blend_csr_fwd_pallas / _blend_csr_kernel :375)")
CSR_BWD_REPLACES = ("activesplat_tpu/ops/raster_pallas.py:736 "
                    "(_blend_csr_bwd_pallas / _blend_csr_bwd_kernel :628)")
DUAL_REPLACES = ("activesplat_tpu/ops/raster_pallas.py:582 "
                 "(blend_csr_dual_pallas / _blend_csr_dual_kernel :514)")
BIN_REPLACES = ("activesplat_tpu/ops/raster_pallas.py:898 "
                "(bin_slots_pallas / _bin_slots_kernel :828)")

# the bin's slot search does integer work: 64 INT32 results per clock per SM
# (Hopper white paper), times the card's maximum SM clock
INT32_PER_CLOCK_PER_SM = 64
BIN_SCENES = ((1000, 256, 256), (500, 144, 96))  # tests/test_raster_tiled.py:324-332
GATE_SCENE_BLOCKS = 4090  # a scene just inside the kernel's gate of 4,096 blocks
BIN_FAULTS = ("slot off by one", "members before the slot counted from its own block",
              "sentinel replaced by the window's last member")
# planted faults of B6's two passes (bin_split_checks)
BIN_SPLIT_FAULTS = ("a rectangle counted one tile wider", "padding words counted as members",
                    "members ranked from the last lane down within a block",
                    "the window test dropping the block where the window starts (lo >= off in "
                    "place of hi > off)")
# kernels of one B6 route call: the count pass, then (after torch.cumsum) the slot pass
B6_PASSES = ("bin_count_kernel", "bin_slots_kernel")
# the row gathers' backward at 512x512: one capped call's tiles x rows, one
# CSR call's entries, a map's Gaussians, the padding row's share of the ids
GATHER_CAPPED = (1024, 1024)
GATHER_CSR_ROWS = 280_000
GATHER_TABLE_ROWS = 2_100_000
GATHER_PAD_SHARE = 0.2
GATHER_WIDTH = 6 + N_CHANNELS
# the bin inputs of phases 3 and 5, kept for scripts/bin_route_trace.py to
# trace another tree's routes on them
BIN_INPUTS = Path(__file__).resolve().parent / "build" / "bin_route_inputs.pt"
# planted faults of the CSR forward kernels' two passes (split_checks)
SPLIT_FAULTS = ("the combine reading its partials one segment off",
                "the exit tested after accumulating", "the dead-pair margin's sign flipped")
# kernels of one B3 or B5 wrapper call: each segment alone, then the per-tile combine
CSR_PASSES = ("csr_partials_kernel", "csr_combine_kernel")
# kernels of one B1 wrapper call: each tile segment alone, then the per-tile combine
B1_PASSES = ("tile_fwd_partials_kernel", "tile_fwd_combine_kernel")
# planted faults of B1's two passes (tile_fwd_split_checks)
TILE_FWD_FAULTS = ("a per-segment exit in place of the whole-tile one (each segment left out on "
                   "its own step, not on the tile's carried logT)",
                   "the partials of a tile's first two segments swapped",
                   "one warp dropped from the rows' reach masks",
                   "a stash written only for walked segments",
                   "the dead-pair margin's sign flipped")
# kernels of one B2 wrapper call: each segment's suffix total, then the walk
B2_PASSES = ("tile_bwd_suffix_kernel", "tile_bwd_walk_kernel")
# planted faults of B2's two passes (tile_bwd_split_checks)
TILE_SPLIT_FAULTS = ("the walk fed the totals one segment toward the front (each fold takes "
                     "its own segment's)", "the walk fed the totals one segment back (each fold "
                     "misses the next segment's)", "the dead-pair margin's sign flipped")
# kernels of one B4 wrapper call: each 64-row piece's log step and total,
# then the walk from the fold of the later totals
B4_PASSES = ("csr_bwd_pieces_kernel", "csr_bwd_walk_kernel")
# planted faults of B4's two passes (csr_bwd_split_checks)
B4_SPLIT_FAULTS = ("the walk fed the piece totals one piece toward the front",
                   "the walk fed the piece totals one piece back",
                   "a piece skipped by its own entry logT (not its segment's)",
                   "the dead-pair margin's sign flipped")

# the small driver check's frames at the hermetic episode's configuration
# (activesplat_tpu/runtime/launch.py:33-69: two_room, seed 0, 90 degrees
# hfov, depth to 10 m, MapperConfig() defaults)
DRIVER_STEP_NUM = 500  # the episode's step budget (make_synthetic_dataset)
CAMERA_HEIGHT = 1.25  # RGBDSensor.position above the agent's base
TURN_DEG = 10.0  # SyntheticDataset's turn and forward step
FORWARD_STEP = 0.065

# the small card-against-CPU episode: tests/test_torch_episode.py's parity
# run (single_room seed 2, 48x48, 45 degree turns, 18 steps, the lean
# mapper), which plans its first target after the 16 actions of its spin,
# reaches it at tick 3 (0.798 px from it, px_as_arrived 0.827) and begins
# the local refinement there. Its buffer may grow to 32,768 Gaussians, above the 10,256 the run
# makes, so that the count at the end is the mapper's and not the cap's.
SMALL_EPISODE = dict(res=48, steps=18, turn=45.0, start=(3.0, 0.0, 3.0))
SMALL_EPISODE_CFG = dict(initial_capacity=1 << 12, max_capacity=1 << 15, keyframe_capacity=64,
                         mapping_iters=2, map_every=5, kf_every=5, mapping_window_size=5,
                         chunk=128, kf_select_pixels=128, k_per_tile=1024, exact_training="off",
                         exact_online_metrics=False)
# the small episode's explored free-map area and Gaussian count at the end,
# card against CPU
EPISODE_AREA_RTOL = 0.02
EPISODE_GAUSSIAN_RTOL = 0.02

# the judges, card against CPU, over the small episode's dump: the map
# judge's k (scripts/rescore_episode.py's EP_K); the scores of one map
# within the tolerance of tests/test_torch_judges.py, LPIPS within that of
# tests/test_torch_eval.py, the offline fit's Gaussian count within that of
# tests/test_torch_modes.py. The fit's end metrics are held to 1e-3, not to
# that test's 1e-5 (the JAX and port fits on one CPU): the quaternions of
# still-spherical Gaussians have a true gradient of 0, and Adam's eps of
# 1e-15 turns their rounding noise (1e-10) into whole learning-rate steps
# whose signs follow the summation order, so the two devices' maps part
# from the second mapping event on (the PSNR by 1.04e-4 relative on an
# H100). The first event's gradients are held instead: no sign differs
# among those above 1e-6 of their field's largest, and 99% of them agree
# within FIT_GRAD_RTOL.
EVAL_K = 1024
JUDGE_RTOL, JUDGE_ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_GAUSSIAN_RTOL = 1e-3, 2e-3
FIT_GRAD_RTOL = 1e-3
LPIPS_REL = 1e-4

# the planner's map queries at bench.py's query size (bench_queries,
# bench.py:124-156, at its default of 1,000,000 Gaussians)
QUERY_GAUSSIANS = 1_000_000
QUERY_BBOX = ((0.0, 10.0), (0.0, 3.0), (0.0, 6.0))  # top-down: a 216 x 360 px grid
QUERY_NODES = ((4.0, 1.25, 2.0), (6.0, 1.25, 3.0))  # two panorama nodes at scale 0.5
QUERY_VIEW = (5.0, 1.25, 1.5)  # the camera's position
DUAL_CHANNELS = 3  # the top-down walk composites rgb

# phase 5, the kernels at 512x512: the gibson_high_resolution scene config's
# mapper (512x512, mapping_iters 10, map_every 5) builds a map of its
# benchmark cell's room (BoxWorld.single_room(87)) from MAP_FRAMES frames of
# the small driver check's walk; the kernels take its renders at k=HIGH_K
# and its top-down map at the config's pixel_max of 360
HIGH_CONFIG = "gibson_high_resolution"
HIGH_RES = 512
HIGH_K = 1024
HIGH_WORLD_SEED = 87
MAP_FRAMES = 4
# the small card-against-CPU mock episode: tests/test_torch_habitat_episode.py's
# parity run (the gibson config on a 48x48 env yaml, 45 degree turns, scene
# id Elmira, 18 steps, the lean mapper of SMALL_EPISODE_CFG)
HABITAT_SMALL = dict(res=48, steps=18, turn=45.0, scene="Elmira")
# the native raycaster against the numpy one (tests/test_native.py's tolerance)
NATIVE_ATOL = 1e-4
NATIVE_REPS = 5

# phase 4, the multi-device path on a virtual mesh of the one card: the row
# shards of parallel/sharded.py, MESH_SHARDS of them naming cuda:0, on phase
# 3's map at RES x RES (64 rows a shard); one mapping event, the driver over
# MESH_FRAMES frames, the panorama queries on phase 3's query map.
MESH_SHARDS = 4
MESH_EVENT_ITERS = 10
MESH_FRAMES = 10
# Tolerances, sharded against unsharded on one card. A shard's means shift
# by a whole number of tile rows, exactly in float32 and on the bins' 1/8 px
# grid, so its tiles get the full frame's rows and their pixel offsets round
# alike: the images agree to MESH_IMG_REL of each field's largest value
# (bitwise, expected) and the loss to MESH_LOSS_RTOL. The gradient of a
# Gaussian that spans two shards sums the shards' parts once more:
# MESH_GRAD_REL of each field's largest. A mapping event's later iterations
# and the driver's metrics part as FIT_RTOL says (Adam's eps of 1e-15 on
# zero-gradient quaternions): MESH_METRIC_RTOL.
MESH_IMG_REL = 1e-6
MESH_LOSS_RTOL = 1e-6
MESH_GRAD_REL = 1e-5
MESH_METRIC_RTOL = FIT_RTOL

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


# calls traced ahead of the averaged window: the trace has missed up to 17
# of the first launches after it starts (H100 runs), and a retry doubles them
EXTRA_CALLS = 40


def kernel_device_ms(torch, fn, kernels, reps: int) -> dict:
    """The device time per call of each CUDA kernel of one wrapper call:
    {name: ms} for each name in `kernels` (a kernel is the one whose name
    contains it, launched once per call), the mean of exactly the last
    `reps` launches of it in a torch.profiler trace of reps + EXTRA_CALLS
    (or, on a retry, more) calls of the wrapper `fn`; each reading is printed with the launches
    it averages and those the trace held. The wrapper's host work and its
    small helper kernels are left out (back-to-back wrapper calls measure
    the host when the kernels are shorter than the wrapper's Python)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    # the trace may miss the first launches after it starts: the extra calls
    # absorb that; a trace holding fewer than reps launches of a kernel, or
    # more than one per call, is traced again with twice the extra calls (at
    # most four traces)
    for attempt in range(4):
        calls = reps + EXTRA_CALLS * 2 ** attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = {k: sorted((e.time_range.start, e.time_range.elapsed_us()) for e in events
                           if k in e.name) for k in kernels}
        seen = {k: len(v) for k, v in spans.items()}
        if all(reps <= n <= calls for n in seen.values()):
            out = {k: sum(us for _, us in v[-reps:]) / reps / 1e3 for k, v in spans.items()}
            print("  device ms: " + ", ".join(f"{k} {out[k]:.4f} (the last {reps} of {seen[k]} "
                                              f"launches traced in {calls} calls)" for k in kernels))
            return out
        print(f"the profiler saw {seen} launches in {calls} calls; tracing again")
    raise AssertionError(f"the profiler saw {seen} launches in {calls} calls")


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


def kernel_checks(torch, rc, rows, u0, v0, tag: str, rejected, fwd_rejected):
    """Each kernel against its twin on the same inputs, and the two passes
    of B1 and of B2 against their plain versions (tile_fwd_split_checks and
    tile_bwd_split_checks, which count the planted faults they reject in
    `fwd_rejected` and `rejected`); errs["segments"] is B1's (computed,
    walked).

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
    segments = tile_fwd_split_checks(torch, rc, rows, u0, v0, (acc_k, lt_k, ent_k), tag,
                                     fwd_rejected)

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
    tile_bwd_split_checks(torch, rc, (rows, u0, v0, ent_k, g_acc, g_lt, c), d_k, tag, rejected)

    errs = {
        "fwd": max(float((acc_k - acc_p).abs().max()),
                   float((lt_k[strict] - lt_p[strict]).abs().max()),
                   float((ent_k[strict] - ent_p[strict]).abs().max())),
        "bwd": float((d_k - d_p).abs().max()),
        "segments": segments,
    }
    print(f"{tag}: {int(near.sum())} boundary tiles; blend_tiles_fwd max_abs_err={errs['fwd']:.3e} "
          f"({shares['fwd']:.3f} of tolerance), blend_tiles_bwd max_abs_err={errs['bwd']:.3e} "
          f"({shares['bwd']:.3f} of tolerance); bwd max err per column / column max: "
          + " ".join(f"{float(x):.1e}" for x in per_col[:6 + c]))
    return errs, (ent_k, g_acc, g_lt)


def tile_threshold_pairs(torch, rc, rows, u0, v0):
    """Per (tile, segment, pixel): the pairs whose raw alpha lies within
    EDGE_RTOL of ALPHA_MIN (power <= 0), as float32 counts."""
    px, py = rc._pixel_coords(u0, v0)
    out = []
    for s in range(rows.shape[1] // rc.SEG):
        _, _, power, raw, _, _ = rc._segment_geometry(rows[:, s * rc.SEG:(s + 1) * rc.SEG], px, py)
        out.append(((power <= 0) & ((raw / rc.ALPHA_MIN - 1).abs() < EDGE_RTOL)).sum(dim=1))
    return torch.stack(out, dim=1).float()


def combine_own_step_exit(torch, rc, partials, c):
    """tile_fwd_combine_plain with one planted fault: each segment is left
    out on its own step (max_p L < LOG_EPS), not on the tile's carried
    logT, so a segment that saturates its tile by itself is dropped and the
    tile walks on past its exit."""
    t, n_seg = partials.shape[:2]
    accum = partials.new_zeros((t, rc.PX, c))
    logt = partials.new_zeros((t, rc.PX))
    entries = []
    for s in range(n_seg):
        entries.append(logt)
        q = partials[:, s]
        walk = (q[:, :, c].amax(dim=1) >= rc.LOG_EPS)[:, None]
        accum = torch.where(walk[:, :, None], accum + torch.exp(logt)[:, :, None] * q[:, :, :c], accum)
        logt = torch.where(walk, logt + q[:, :, c], logt)
    return accum, logt, torch.stack(entries, dim=1)


def tile_fwd_split_checks(torch, rc, rows, u0, v0, wrapper_out, tag, rejected):
    """Each pass of B1 against its plain version on one set of tile rows,
    `wrapper_out` the wrapper's (accum, logT, stash). Pass 1 runs into a
    NaN-filled scratch with the dead-pair audit on: no pair that the
    dead-pair test or the warp reach mask kills may be live by the full
    formula, and every segment the wrapper's combine walked (its stash at
    least LOG_EPS at some pixel) is computed; the computed segments'
    partials agree with tile_fwd_partials_plain (split_checks' tolerances:
    log steps to LOGT_ATOL + STEP_RTOL |step|, colour partials to REL_TOL of
    each channel's largest value plus LOGT_ATOL of their own value, plus
    what a pair within EDGE_RTOL of ALPHA_MIN alone can move). The combine,
    fed the kernel's own partials, gives tile_fwd_combine_plain's logT and
    stash bitwise and its image to REL_TOL, and the same outputs bitwise
    with 1e30 in the partials of every segment it does not walk; the
    wrapper's outputs equal the two passes' bitwise, and a second wrapper
    call equals the first. Planted faults (TILE_FWD_FAULTS) must be
    rejected where they change the result; `rejected` counts them. Returns
    (segments computed, segments walked)."""
    c = N_CHANNELS
    t, k, _ = rows.shape
    walked = wrapper_out[2].amax(dim=2) >= rc.LOG_EPS  # (T, K/SEG)
    audit = torch.zeros(1, dtype=torch.int32, device="cuda")
    part = torch.full((t, k // rc.SEG, rc.PX, c + 1), float("nan"), device="cuda")
    rc.tile_fwd_partials_cuda(rows, u0, v0, c, out=part, audit=audit)

    def none_killed(count):
        if count:
            raise AssertionError(f"{tag}: B1's dead-pair test and reach mask killed {count} live pairs")

    none_killed(int(audit))
    computed = ~torch.isnan(part).any(dim=(2, 3))
    if bool((walked & ~computed).any()):
        raise AssertionError(f"{tag}: B1 pass 1 left {int((walked & ~computed).sum())} walked "
                             f"segments unwritten")
    plain = rc.tile_fwd_partials_plain(rows, u0, v0, c)
    got, want = part[computed], plain[computed]  # (segments, PX, C + 1)
    col_max = want[:, :, :c].abs().amax(dim=(0, 1))
    edge = tile_threshold_pairs(torch, rc, rows, u0, v0)[computed][:, :, None]
    a_edge = rc.ALPHA_MIN * (1 + EDGE_RTOL)
    col_rows = rows[:, :, 6:6 + c].abs().amax(dim=(0, 1))
    share1 = max(check_close(f"{tag} B1 pass 1 colour partials", got[:, :, :c], want[:, :, :c],
                             REL_TOL * col_max + LOGT_ATOL * want[:, :, :c].abs()
                             + edge * a_edge * (col_rows + want[:, :, :c].abs())),
                 check_close(f"{tag} B1 pass 1 log steps", got[:, :, c:], want[:, :, c:],
                             LOGT_ATOL + STEP_RTOL * want[:, :, c:].abs()
                             - edge * math.log1p(-a_edge)))

    comb = rc.tile_fwd_combine_cuda(part, c, with_entry=True)
    acc_max = comb[0].abs().amax(dim=(0, 1))

    def combine_share(candidate):
        """The combine's outputs against `candidate` (tile_fwd_combine_plain's,
        or a faulty version): logT and the stash bitwise, accum to REL_TOL of
        each channel's largest value."""
        for what, got_c, want_c in zip(("logT", "stash"), comb[1:], candidate[1:]):
            if not torch.equal(got_c, want_c):
                raise AssertionError(f"{tag}: B1's combine {what} is not bitwise its plain "
                                     f"version's at {int((got_c != want_c).sum())} values")
        return check_close(f"{tag} B1 combine accum", candidate[0], comb[0], REL_TOL * acc_max)

    plain_comb = rc.tile_fwd_combine_plain(part, c, with_entry=True)
    share2 = combine_share(plain_comb)
    junk = torch.where(walked[:, :, None, None], part, torch.full_like(part, 1e30))
    if not all(torch.equal(a, b) for a, b in zip(rc.tile_fwd_combine_cuda(junk, c, True), comb)):
        raise AssertionError(f"{tag}: B1's combine depends on partials it does not walk")
    if not all(torch.equal(a, b) for a, b in zip(wrapper_out, comb)):
        raise AssertionError(f"{tag}: the B1 wrapper's outputs differ from its two passes'")
    if not all(torch.equal(a, b) for a, b in
               zip(rc.blend_tiles_fwd(rows, u0, v0, c, with_entry=True), wrapper_out)):
        raise AssertionError(f"{tag}: two B1 wrapper calls on the same inputs differ")

    swapped = part.clone()
    swapped[:, :2] = part[:, [1, 0]]  # K >= 128 on every set of rows checked
    own = combine_own_step_exit(torch, rc, part, c)
    first_only = (plain_comb[0], plain_comb[1],
                  torch.where(walked[:, :, None], plain_comb[2], torch.zeros_like(plain_comb[2])))
    dropped = torch.zeros(1, dtype=torch.int32, device="cuda")
    rc.tile_fwd_partials_cuda(rows, u0, v0, c, audit=dropped, drop_warps=1)
    flip = torch.zeros(1, dtype=torch.int32, device="cuda")
    rc.tile_fwd_partials_cuda(rows, u0, v0, c, margin=-rc.DEAD_MARGIN, audit=flip)
    candidates = {TILE_FWD_FAULTS[0]: own,
                  TILE_FWD_FAULTS[1]: rc.tile_fwd_combine_plain(swapped, c, with_entry=True),
                  TILE_FWD_FAULTS[3]: first_only}
    faults = {name: (lambda x=x: combine_share(x)) for name, x in candidates.items()}
    shows = {name: not all(torch.equal(a, b) for a, b in zip(x, plain_comb))
             for name, x in candidates.items()}
    faults[TILE_FWD_FAULTS[2]] = lambda: none_killed(int(dropped))
    shows[TILE_FWD_FAULTS[2]] = int(dropped) > 0
    faults[TILE_FWD_FAULTS[4]] = lambda: none_killed(int(flip))
    shows[TILE_FWD_FAULTS[4]] = int(flip) > 0
    for name, check in faults.items():
        if shows[name]:
            must_reject(name, check)
            rejected[name] += 1
    n_computed, n_walked = int(computed.sum()), int(walked.sum())
    print(f"{tag}: B1 pass 1 computed {n_computed} of {computed.numel()} tile segments "
          f"({n_walked} walked; {int(edge.sum())} pairs at the alpha threshold), 0 live pairs "
          f"killed by the dead-pair test and reach mask ({int(flip)} with the margin flipped, "
          f"{int(dropped)} with warp 0 dropped from the masks), partials within {share1:.3f} of "
          f"tolerance; the combine's logT and stash bitwise its plain version's, image within "
          f"{share2:.3f}; the wrapper equals its passes bitwise and repeats bitwise; "
          f"{sum(shows.values())} planted faults rejected")
    return n_computed, n_walked


def tile_bwd_split_checks(torch, rc, bwd_args, d_k, tag, rejected):
    """Each pass of B2 against its plain version on one set of tile rows.
    Pass 1 runs into a NaN-filled scratch with the dead-pair audit on: no
    pair that the dead-pair test or the warp reach mask kills may be live by
    the full formula, no NaN may remain, and the segments the forward skipped
    get exact zeros; the totals agree with tile_bwd_suffix_plain to REL_TOL of
    the largest |S| (where a pair's raw alpha lies within EDGE_RTOL of
    ALPHA_MIN, plus what that pair alone can move: its weight and the
    transmittance behind it, 2 ALPHA_MIN max_j |s_j|). Pass 2 fed the
    kernel's totals agrees with tile_bwd_walk_plain fed the same totals at
    the per-column tolerance of kernel_checks, and gives zero rows where the
    forward skipped. The wrapper's output `d_k` equals its two passes
    bitwise, and a second wrapper call equals the first. Planted faults
    (TILE_SPLIT_FAULTS), each made by changing an input of a kernel, must be
    rejected where they change the result; `rejected` counts them."""
    rows, u0, v0, entry, g_acc, g_lt, c = bwd_args
    walked = entry.amax(dim=2) >= rc.LOG_EPS  # (T, K/SEG)
    audit = torch.zeros(1, dtype=torch.int32, device="cuda")
    suffix = torch.full(entry.shape, float("nan"), device="cuda")
    rc.tile_bwd_suffix_cuda(rows, u0, v0, entry, g_acc, c, out=suffix, audit=audit)

    def none_killed(count):
        if count:
            raise AssertionError(f"{tag}: B2's dead-pair test killed {count} live pairs")

    none_killed(int(audit))
    if bool(torch.isnan(suffix).any()) or bool(suffix[~walked].any()):
        raise AssertionError(f"{tag}: B2 pass 1 left {int(torch.isnan(suffix).sum())} NaN and "
                             f"{int((suffix[~walked] != 0).sum())} non-zero skipped totals")
    plain = rc.tile_bwd_suffix_plain(rows, u0, v0, entry, g_acc, c)
    s_max = (rows[:, :, 6:6 + c].abs().amax(dim=1)[:, None, :] * g_acc.abs()).sum(-1)  # (T, PX)
    edge = tile_threshold_pairs(torch, rc, rows, u0, v0)
    share1 = check_close(f"{tag} B2 pass 1 totals", suffix, plain,
                         REL_TOL * plain.abs().max()
                         + edge * 2 * rc.ALPHA_MIN * (1 + EDGE_RTOL) * s_max[:, None, :])

    d_walk = rc.tile_bwd_walk_cuda(rows, u0, v0, entry, g_acc, g_lt, suffix, c)
    want = rc.tile_bwd_walk_plain(rows, u0, v0, entry, g_acc, g_lt, suffix, c)
    d_lim = REL_TOL * want.abs().amax(dim=(0, 1))

    def walk_share(d):
        return check_close(f"{tag} B2 pass 2", d, want, d_lim)

    share2 = walk_share(d_walk)
    if bool(d_walk.view(*walked.shape, -1)[~walked].any()):
        raise AssertionError(f"{tag}: B2 pass 2 wrote non-zero rows where the forward skipped")
    if not torch.equal(d_walk, d_k):
        raise AssertionError(f"{tag}: the B2 wrapper's output differs from its two passes'")
    if not torch.equal(rc.blend_tiles_bwd(*bwd_args), d_k):
        raise AssertionError(f"{tag}: two B2 wrapper calls on the same inputs differ")

    zero = torch.zeros_like(suffix[:, :1])
    front = torch.cat([zero, suffix[:, :-1]], dim=1)  # the fold of s takes S_s
    back = torch.cat([suffix[:, 1:], zero], dim=1)  # the fold of s misses S_{s+1}
    flip = torch.zeros(1, dtype=torch.int32, device="cuda")
    rc.tile_bwd_suffix_cuda(rows, u0, v0, entry, g_acc, c, margin=-rc.DEAD_MARGIN, audit=flip)
    shifted = {TILE_SPLIT_FAULTS[0]: front, TILE_SPLIT_FAULTS[1]: back}
    d_shifted = {name: rc.tile_bwd_walk_cuda(rows, u0, v0, entry, g_acc, g_lt, x, c)
                 for name, x in shifted.items()}
    faults = {name: (lambda d=d: walk_share(d)) for name, d in d_shifted.items()}
    faults[TILE_SPLIT_FAULTS[2]] = lambda: none_killed(int(flip))
    # a shifted fold shows where it moves some walked segment's carry by more
    # than a thousandth of the largest total
    def fold(x):
        return x.flip(1).cumsum(1).flip(1) - x

    moved = {name: float(((fold(x) - fold(suffix)) * walked[:, :, None]).abs().max())
             for name, x in shifted.items()}
    shows = {name: moved[name] > 1e-3 * float(suffix.abs().max()) for name in shifted}
    shows[TILE_SPLIT_FAULTS[2]] = int(flip) > 0
    for name, check in faults.items():
        if shows[name]:
            must_reject(name, check)
            rejected[name] += 1
    print(f"{tag}: B2 pass 1 wrote every total ({int(walked.sum())} of {walked.numel()} segments "
          f"walked, {int(edge.sum())} pairs at the alpha threshold), 0 live pairs killed by the "
          f"dead-pair test and reach mask ({int(flip)} with the margin flipped), totals within "
          f"{share1:.3f} of tolerance; pass 2 within {share2:.3f}; the wrapper equals its passes "
          f"bitwise and repeats bitwise; {sum(shows.values())} planted faults rejected")


def random_csr_stream(torch, seed: int, n_tiles: int = 256):
    """A CSR stream (entry_data (E, 16), seg_tile, seg_u0, seg_v0) with the
    edge cases mixed in: tiles 0-15 have no segment, 16-47 saturate in the
    first of their three segments (large, opaque Gaussians), 48-63 hold
    eight segments each, the rest one to four; every tile's last segment
    ends in padding rows after a random length, and three padding segments
    keyed to the padding tile n_tiles close the stream."""
    from activesplat_tpu_torch.ops.raster_cuda import CSEG, N_ATTR, TILE

    g = torch.Generator(device="cpu").manual_seed(seed)
    tiles_x = 16

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    counts = torch.randint(1, 5, (n_tiles,), generator=g)
    counts[:16] = 0
    counts[16:48] = 3
    counts[48:64] = 8
    seg_tile = torch.cat([torch.repeat_interleave(torch.arange(n_tiles), counts),
                          torch.full((3,), n_tiles)])
    e = seg_tile.shape[0] * CSEG
    tile = seg_tile.repeat_interleave(CSEG)  # (E,) each row's tile
    rows = torch.zeros((e, N_ATTR))
    rows[:, 0] = (tile % tiles_x) * TILE + unif(-8, 24, e)
    rows[:, 1] = torch.div(tile, tiles_x, rounding_mode="floor") * TILE + unif(-8, 24, e)
    rows[:, 2] = unif(0.02, 0.6, e)
    rows[:, 3] = unif(-0.02, 0.02, e)
    rows[:, 4] = unif(0.02, 0.6, e)
    rows[:, 5] = unif(0.02, 0.5, e)
    rows[:, 6:6 + N_CHANNELS] = unif(0, 1, e, N_CHANNELS)
    sat = (tile >= 16) & (tile < 48)
    n_sat = int(sat.sum())
    rows[sat, 2] = unif(0.001, 0.01, n_sat)
    rows[sat, 3] = 0.0
    rows[sat, 4] = unif(0.001, 0.01, n_sat)
    rows[sat, 5] = unif(0.9, 0.99, n_sat)
    # each run: (count - 1) full segments, then 1..CSEG members, then padding
    first_row = torch.cumsum(counts, 0) * CSEG - counts * CSEG
    length = counts * CSEG - torch.randint(0, CSEG, (n_tiles,), generator=g)
    in_grid = tile < n_tiles
    rank = torch.arange(e) - first_row[tile.clamp(max=n_tiles - 1)]
    pad = ~in_grid | (rank >= length[tile.clamp(max=n_tiles - 1)])
    rows[pad] = torch.tensor([-1e9, -1e9, 1.0, 1.0, 1.0] + [0.0] * (N_ATTR - 5))
    grid = seg_tile < n_tiles
    seg_u0 = torch.where(grid, (seg_tile % tiles_x) * TILE, 0)
    seg_v0 = torch.where(grid, torch.div(seg_tile, tiles_x, rounding_mode="floor") * TILE, 0)
    return (rows.cuda(), *(x.to(torch.int32).cuda() for x in (seg_tile, seg_u0, seg_v0)))


def csr_bwd_carry_leak(torch, rc, stream, entry, g_acc, g_lt, n_tiles):
    """B4's twin with one planted fault: the suffix carry is not reset at a
    tile boundary, so each tile starts from the carry of every tile after
    it, as a kernel would that walked the whole stream back to front with
    one carry."""
    blocks, starts, counts, px, py, ranks = rc._csr_tiles(*stream, n_tiles)
    g = torch.nn.functional.pad(g_acc, (0, rc.MAX_CHANNELS - g_acc.shape[-1]))

    def walk(b):
        d_data = torch.zeros_like(stream[0])
        d_blocks = d_data.view(blocks.shape)
        for r in reversed(range(ranks)):
            act = torch.nonzero(counts > r).squeeze(1)
            seg = starts[act].long() + r
            d_blocks[seg, :, :14], b[act] = rc._bwd_segment(
                blocks[seg], px[act], py[act], entry[seg], g[act], g_lt[act], b[act]
            )
        return d_data, b

    _, total = walk(stream[0].new_zeros((n_tiles, rc.PX)))
    later = total.flip(0).cumsum(0).flip(0) - total  # carries of the tiles after each
    return walk(later)[0]


def threshold_pairs(torch, rc, stream, segs, pieces=1):
    """Per (segment of `segs`, piece, pixel), each segment's rows cut into
    `pieces` pieces: the pairs whose raw alpha lies within EDGE_RTOL of
    ALPHA_MIN (power <= 0), as float32 counts."""
    data, _, seg_u0, seg_v0 = stream
    blocks = data.view(-1, rc.CSEG, rc.N_ATTR)
    out = torch.zeros((segs.numel(), pieces, rc.PX), device=data.device)
    for i, chunk in enumerate(segs.split(64)):
        px, py = rc._pixel_coords(seg_u0[chunk], seg_v0[chunk])
        _, _, power, raw, _, _ = rc._segment_geometry(blocks[chunk], px, py)
        edge = (power <= 0) & ((raw / rc.ALPHA_MIN - 1).abs() < EDGE_RTOL)
        out[64 * i:64 * i + chunk.numel()] = edge.view(chunk.numel(), pieces, -1, rc.PX).sum(dim=2)
    return out


def threshold_logt_allowance(torch, rc, stream, walked, n_tiles):
    """Per (tile, pixel): what the pairs at the alpha threshold in the
    tile's walked segments (`walked`) can move its log-transmittance,
    -log1p(-ALPHA_MIN (1 + EDGE_RTOL)) each. split_checks allows each pass-1
    log step this much (a pair there may be live on one side only: the
    kernels contract the power's products into FMAs); the wrapper's logT and
    stash sum those steps, so they carry the same allowance."""
    seg_tile = stream[1]
    idx = torch.nonzero(walked).squeeze(1)
    per_tile = torch.zeros((n_tiles + 1, rc.PX), device=stream[0].device)
    if idx.numel():
        edge = threshold_pairs(torch, rc, stream, idx)[:, 0, :]
        per_tile.index_add_(0, seg_tile[idx].long().clamp(max=n_tiles), edge)
    return per_tile[:n_tiles] * -math.log1p(-rc.ALPHA_MIN * (1 + EDGE_RTOL))


def combine_exit_late(torch, rc, partials, seg_tile, n_tiles, c, dual):
    """csr_combine_plain with one planted fault: the exit is tested after
    accumulating, so the first segment whose entry carry is already below
    LOG_EPS is still composited before the tile stops."""
    starts, counts = rc._tile_segments(seg_tile, n_tiles)
    accum = partials.new_zeros((n_tiles, rc.PX, c))
    logt = partials.new_zeros((n_tiles, rc.PX))
    band = partials.new_zeros((n_tiles, rc.PX))
    entry = partials.new_zeros((partials.shape[0], rc.PX))
    stopped = torch.zeros(n_tiles, dtype=torch.bool, device=partials.device)
    for r in range(int(counts.max()) if n_tiles else 0):
        has = torch.nonzero(counts > r).squeeze(1)
        entry[starts[has].long() + r] = logt[has]
        act = torch.nonzero((counts > r) & ~stopped).squeeze(1)
        seg = starts[act].long() + r
        saturated = (band if dual else logt)[act].amax(dim=1) < rc.LOG_EPS
        q = partials[seg]
        accum[act] = accum[act] + torch.exp(logt[act])[:, :, None] * q[:, :, :c]
        logt[act] = logt[act] + q[:, :, c]
        if dual:
            band[act] = band[act] + q[:, :, c + 1]
        stopped[act[saturated]] = True
    return (accum, logt) + ((band,) if dual else (entry,))


def csr_bwd_split_checks(torch, rc, stream, n_tiles, c, bwd_inputs, d_k, tag, rejected):
    """Each pass of B4 against its plain version on one CSR stream. Pass 1
    runs into a NaN-filled scratch with the dead-pair audit on: no pair that
    the dead-pair test or the warp reach mask kills may be live by the full
    formula, no NaN may remain, and skipped and padding segments get exact
    zeros. Its log steps agree with csr_bwd_pieces_plain's to LOGT_ATOL +
    STEP_RTOL |L| and its totals to REL_TOL of the largest |W|; where a
    pair's raw alpha lies within EDGE_RTOL of ALPHA_MIN, plus what that pair
    alone moves (-log1p(-ALPHA_MIN) of a step; of a total its own weight and
    the transmittance behind it, 2 ALPHA_MIN max_j |s_j|). Pass 2 fed the
    kernel's piece totals agrees with csr_bwd_walk_plain fed the same to
    REL_TOL of each column's largest value, with zero rows where the segment
    is skipped or padding. The wrapper's output `d_k` equals its two passes
    bitwise, and a second wrapper call equals the first. Planted faults
    (B4_SPLIT_FAULTS) must be rejected where they change the result;
    `rejected` counts them."""
    entry, g_acc, g_lt = bwd_inputs
    seg_tile = stream[1]
    n_seg = seg_tile.shape[0]
    walk = rc._csr_walked(entry, seg_tile, n_tiles)
    audit = torch.zeros(1, dtype=torch.int32, device="cuda")
    pieces = torch.full((n_seg, rc.N_PIECES, rc.PX, 2), float("nan"), device="cuda")
    rc.csr_bwd_pieces_cuda(*stream, entry, g_acc, n_tiles, c, out=pieces, audit=audit)

    def none_killed(count):
        if count:
            raise AssertionError(f"{tag}: B4's dead-pair test killed {count} live pairs")

    none_killed(int(audit))
    if bool(torch.isnan(pieces).any()) or bool(pieces[~walk].any()):
        raise AssertionError(f"{tag}: B4 pass 1 left {int(torch.isnan(pieces).sum())} NaN and "
                             f"{int((pieces[~walk] != 0).sum())} non-zero values on skipped or "
                             f"padding segments")
    plain = rc.csr_bwd_pieces_plain(*stream, entry, g_acc, n_tiles, c)
    segs = torch.nonzero(walk).squeeze(1)
    edge = torch.zeros((n_seg, rc.N_PIECES, rc.PX), device="cuda")
    edge[segs] = threshold_pairs(torch, rc, stream, segs, rc.N_PIECES)
    a_edge = rc.ALPHA_MIN * (1 + EDGE_RTOL)
    tile = seg_tile.long().clamp(max=max(n_tiles - 1, 0))
    col_rows = stream[0][:, 6:6 + c].abs().view(n_seg, -1, c).amax(dim=1)  # (n_seg, C)
    s_max = (col_rows[:, None, :] * g_acc.abs()[tile]).sum(-1)[:, None, :]  # (n_seg, 1, PX)
    share1 = max(
        check_close(f"{tag} B4 pass 1 log steps", pieces[..., 0], plain[..., 0],
                    LOGT_ATOL + STEP_RTOL * plain[..., 0].abs() - edge * math.log1p(-a_edge)),
        check_close(f"{tag} B4 pass 1 totals", pieces[..., 1], plain[..., 1],
                    REL_TOL * plain[..., 1].abs().max() + edge * 2 * a_edge * s_max))

    d_walk = rc.csr_bwd_walk_cuda(*stream, entry, g_acc, g_lt, pieces, n_tiles, c)
    want = rc.csr_bwd_walk_plain(*stream, entry, g_acc, g_lt, pieces, n_tiles, c)
    d_lim = REL_TOL * want.abs().amax(dim=0)

    def walk_share(d):
        return check_close(f"{tag} B4 pass 2", d, want, d_lim)

    share2 = walk_share(d_walk)
    if bool(d_walk.view(n_seg, -1)[~walk].any()):
        raise AssertionError(f"{tag}: B4 pass 2 wrote non-zero rows on skipped or padding segments")
    if not torch.equal(d_walk, d_k):
        raise AssertionError(f"{tag}: the B4 wrapper's output differs from its two passes'")
    if not torch.equal(rc.blend_csr_bwd(*stream, entry, g_acc, g_lt, n_tiles, c), d_k):
        raise AssertionError(f"{tag}: two B4 wrapper calls on the same inputs differ")

    zero = torch.zeros_like(pieces[:, :1])
    shifted = {B4_SPLIT_FAULTS[0]: torch.cat([zero, pieces[:, :-1]], dim=1),
               B4_SPLIT_FAULTS[1]: torch.cat([pieces[:, 1:], zero], dim=1)}
    faults = {name: (lambda x=x: walk_share(rc.csr_bwd_walk_cuda(
        *stream, entry, g_acc, g_lt, x.contiguous(), n_tiles, c))) for name, x in shifted.items()}
    shows = {name: bool((x != pieces)[walk].any()) for name, x in shifted.items()}
    # a kernel that skipped a piece by its own entry logT: zero rows there
    steps = torch.cat([torch.zeros_like(pieces[:, :1, :, 0]), pieces[:, :-1, :, 0]], dim=1)
    own_skip = walk[:, None] & ((entry[:, None, :] + steps.cumsum(1)).amax(dim=2) < rc.LOG_EPS)
    d_own = d_walk.clone()
    d_own.view(n_seg, rc.N_PIECES, -1)[own_skip] = 0.0
    faults[B4_SPLIT_FAULTS[2]] = lambda: walk_share(d_own)
    shows[B4_SPLIT_FAULTS[2]] = bool(((d_walk - d_own).abs() > d_lim).any())
    flip = torch.zeros(1, dtype=torch.int32, device="cuda")
    rc.csr_bwd_pieces_cuda(*stream, entry, g_acc, n_tiles, c, margin=-rc.DEAD_MARGIN, audit=flip)
    faults[B4_SPLIT_FAULTS[3]] = lambda: none_killed(int(flip))
    shows[B4_SPLIT_FAULTS[3]] = int(flip) > 0
    for name, check in faults.items():
        if shows[name]:
            must_reject(name, check)
            rejected[name] += 1
    print(f"{tag}: B4 pass 1 wrote every piece ({int(walk.sum())} of {n_seg} segments walked, "
          f"{int(own_skip.sum())} of their pieces entered below LOG_EPS, {int(edge.sum())} pairs at "
          f"the alpha threshold), 0 live pairs killed by the dead-pair test and reach mask "
          f"({int(flip)} with the margin flipped), steps and totals within {share1:.3f} of "
          f"tolerance; pass 2 within {share2:.3f}; the wrapper equals its passes bitwise and "
          f"repeats bitwise; {sum(shows.values())} planted faults rejected")


def split_checks(torch, rc, stream, n_tiles, c, dual, walked, wrapper_out, tag, rejected):
    """Each pass of B3 (or B5 with `dual`) against its plain version on one
    CSR stream. Pass 1 runs into a NaN-filled scratch with the dead-pair
    audit on: no pair that the dead-pair test kills may be live by the full
    formula; no padding segment is computed and every segment that the
    sequential walk walks (`walked`) is; the computed segments' partials
    agree with csr_partials_plain (log steps to LOGT_ATOL + STEP_RTOL |step|:
    the plain version sums them with cumsum; colour partials to REL_TOL of
    each channel's largest value plus LOGT_ATOL of their own value, the log
    prefix's tolerance carried through exp; where a pair's raw alpha lies
    within EDGE_RTOL of ALPHA_MIN, what that pair alone can move). The
    combine, fed the kernel's own partials, gives csr_combine_plain's logT
    and stash (B5: band logT) bitwise and its image to REL_TOL, and the same
    outputs bitwise with 1e30 in the partials of every segment it does not
    walk; the wrapper's outputs `wrapper_out` equal the two passes' bitwise,
    whatever the kernel skipped. Planted faults (SPLIT_FAULTS) that change
    the result must be rejected; `rejected` counts them. Returns (segments
    computed, segments walked)."""
    seg_tile = stream[1]
    in_grid = seg_tile < n_tiles
    width = rc.partial_width(c, dual)
    audit = torch.zeros(1, dtype=torch.int32, device="cuda")
    part = torch.full((seg_tile.shape[0], rc.PX, width), float("nan"), device="cuda")
    rc.csr_partials_cuda(*stream, n_tiles, c, dual, out=part, audit=audit)

    def none_killed(count):
        if count:
            raise AssertionError(f"{tag}: the dead-pair test killed {count} live pairs")

    none_killed(int(audit))
    computed = ~torch.isnan(part).any(dim=(1, 2))
    if bool((computed & ~in_grid).any()) or bool((walked & ~computed).any()):
        raise AssertionError(f"{tag}: pass 1 computed {int((computed & ~in_grid).sum())} padding "
                             f"segments and left {int((walked & ~computed).sum())} walked ones")
    plain = rc.csr_partials_plain(stream[0], stream[2], stream[3], c, dual)
    got, want = part[computed], plain[computed]
    col_max = want[:, :, :c].abs().amax(dim=(0, 1))
    # each pair at the alpha threshold may flip: it moves a log step by at
    # most -log1p(-ALPHA_MIN) and a colour partial by ALPHA_MIN (|col| + |P|)
    edge = threshold_pairs(torch, rc, stream, torch.nonzero(computed).squeeze(1))[:, 0, :, None]
    a_edge = rc.ALPHA_MIN * (1 + EDGE_RTOL)
    col_rows = stream[0][:, 6:6 + c].abs().amax(dim=0)
    # a colour partial weighs each row by exp(excl): the log prefix's
    # tolerance, carried through exp, allows LOGT_ATOL of the value itself
    share1 = max(check_close(f"{tag} pass 1 colour partials", got[:, :, :c], want[:, :, :c],
                             REL_TOL * col_max + LOGT_ATOL * want[:, :, :c].abs()
                             + edge * a_edge * (col_rows + want[:, :, :c].abs())),
                 check_close(f"{tag} pass 1 log steps", got[:, :, c:], want[:, :, c:],
                             LOGT_ATOL + STEP_RTOL * want[:, :, c:].abs()
                             - edge * math.log1p(-a_edge)))

    with_entry = not dual
    comb = rc.csr_combine_cuda(part, seg_tile, n_tiles, c, dual, with_entry)
    acc_max = comb[0].abs().amax(dim=(0, 1))

    def combine_share(candidate):
        """The combine's outputs against `candidate` (csr_combine_plain's, or
        a faulty version): logT and the third output bitwise, accum to
        REL_TOL of each channel's largest value."""
        for what, k, p in zip(("logT", "band logT" if dual else "stash"), comb[1:], candidate[1:]):
            if not torch.equal(k, p):
                raise AssertionError(f"{tag}: the combine's {what} is not bitwise its plain "
                                     f"version's at {int((k != p).sum())} values")
        return check_close(f"{tag} combine accum", candidate[0], comb[0], REL_TOL * acc_max)

    plain_comb = rc.csr_combine_plain(part, seg_tile, n_tiles, c, dual, with_entry)
    share2 = combine_share(plain_comb)
    # what the scratch holds for a segment the walk does not take (skipped
    # by pass 1 or past the exit) must not matter, even a huge step
    junk = torch.where(walked[:, None, None], part, torch.full_like(part, 1e30))
    if not all(torch.equal(a, b) for a, b in
               zip(rc.csr_combine_cuda(junk, seg_tile, n_tiles, c, dual, with_entry), comb)):
        raise AssertionError(f"{tag}: the combine's outputs depend on partials it does not walk")
    if not all(torch.equal(a, b) for a, b in zip(wrapper_out, comb)):
        raise AssertionError(f"{tag}: the wrapper's outputs differ from its two passes'")

    flip = torch.zeros(1, dtype=torch.int32, device="cuda")
    rc.csr_partials_cuda(*stream, n_tiles, c, dual, margin=-rc.DEAD_MARGIN, audit=flip)
    late = combine_exit_late(torch, rc, part, seg_tile, n_tiles, c, dual)
    faults = {
        SPLIT_FAULTS[0]: (lambda: combine_share(rc.csr_combine_plain(
            part.roll(1, 0), seg_tile, n_tiles, c, dual, with_entry))),
        SPLIT_FAULTS[1]: (lambda: combine_share(late)),
        SPLIT_FAULTS[2]: (lambda: none_killed(int(flip))),
    }
    shows = {SPLIT_FAULTS[0]: bool(in_grid.any()),
             SPLIT_FAULTS[1]: not all(torch.equal(a, b) for a, b in zip(late, plain_comb)),
             SPLIT_FAULTS[2]: int(flip) > 0}
    for name, check in faults.items():
        if shows[name]:
            must_reject(name, check)
            rejected[name] += 1
    n_computed, n_walked = int(computed.sum()), int(walked.sum())
    print(f"{tag}: pass 1 computed {n_computed} of {int(in_grid.sum())} tile segments "
          f"({n_walked} walked; {int(edge.sum())} pairs at the alpha threshold), 0 live pairs killed by the dead-pair test ({int(flip)} with its "
          f"margin flipped), partials within {share1:.3f} of tolerance; the combine's logT and "
          f"{'band logT' if dual else 'stash'} bitwise its plain version's, image within "
          f"{share2:.3f}; the wrapper equals its passes bitwise; {sum(shows.values())} planted "
          f"faults rejected")
    return n_computed, n_walked


def csr_kernel_checks(torch, rc, stream, n_tiles: int, tag: str, rejected, c: int = N_CHANNELS,
                      with_bwd: bool = True, bwd_rejected=None):
    """B3 and B4 against their twins on one CSR stream of C colour channels,
    with the tolerances of kernel_checks; a tile is a boundary tile when the
    max logT at one of its segment starts lies within BOUNDARY of LOG_EPS on
    either side. Planted faults (a stash shifted by one segment, logT scaled
    by 1.001, and with `with_bwd` each live gradient column zeroed and the
    carry not reset at tile boundaries) must be rejected. Without `with_bwd`
    (a stream only B3 walks) B4 is not run: errs["bwd"] is None. Each pass
    of B3 is held against its plain version (split_checks, which counts the
    planted faults it rejects in `rejected`), and with `with_bwd` each pass
    of B4 (csr_bwd_split_checks, counting in `bwd_rejected`);
    errs["segments"] is (computed, walked)."""
    seg_tile = stream[1]
    shares = {}
    acc_k, lt_k, ent_k = rc.blend_csr_fwd(*stream, n_tiles, c, with_entry=True)
    acc_p, lt_p, ent_p = rc.blend_csr_fwd_plain(*stream, n_tiles, c, with_entry=True)
    in_grid = seg_tile < n_tiles
    seg_near = ((torch.stack([ent_k, ent_p]).amax(dim=2) - rc.LOG_EPS).abs() < BOUNDARY).any(dim=0)
    near = torch.zeros(n_tiles + 1, dtype=torch.bool, device="cuda")
    near[seg_tile[seg_near & in_grid].long()] = True
    near = near[:n_tiles]
    strict_seg = in_grid & ~near[seg_tile.long().clamp(max=n_tiles - 1)]
    near_seg = in_grid & ~strict_seg
    # pairs at the alpha threshold: a tile's allowance bounds every stash of it too
    edge = threshold_logt_allowance(torch, rc, stream, in_grid & (ent_k.amax(dim=1) >= rc.LOG_EPS),
                                    n_tiles)
    edge_seg = edge[seg_tile.long().clamp(max=n_tiles - 1)]

    def fwd_shares(acc, lt, ent):
        chan = acc_p.abs().amax(dim=(0, 1))
        acc_lim = (REL_TOL + (SKIP_ATOL - REL_TOL) * near.float())[:, None, None] * chan
        out = [check_close(f"{tag} csr fwd accum", acc, acc_p, acc_lim)]
        for what, got, want, strict, loose, allow in (
                ("logT", lt, lt_p, ~near, near, edge),
                ("entry", ent, ent_p, strict_seg, near_seg, edge_seg)):
            got_s, want_s = got[strict], want[strict]
            out.append(check_close(f"{tag} csr fwd {what}", got_s, want_s,
                                   LOGT_ATOL + REL_TOL * want_s.abs() + allow[strict]))
            out.append(check_close(f"{tag} csr fwd {what} (boundary tiles)", got[loose].exp(),
                                   want[loose].exp(), torch.tensor(SKIP_ATOL)))
        if bool(ent[~in_grid].any()):
            raise AssertionError(f"{tag}: padding segments' stash is not zero")
        return max(out)

    shares["fwd"] = fwd_shares(acc_k, lt_k, ent_k)
    acc_n, lt_n = rc.blend_csr_fwd(*stream, n_tiles, c)
    if not (torch.equal(acc_n, acc_k) and torch.equal(lt_n, lt_k)):
        raise AssertionError(f"{tag}: the CSR forward with and without the stash differ")
    shifted = ent_k.roll(1, 0)
    shift_shows = bool((shifted != ent_k).any())  # one-segment runs stash only zeros
    if shift_shows:
        must_reject("stash shifted by one segment", lambda: fwd_shares(acc_k, lt_k, shifted))
    must_reject("logT scaled by 1.001", lambda: fwd_shares(acc_k, lt_k * 1.001, ent_k))
    segments = split_checks(torch, rc, stream, n_tiles, c, False,
                            in_grid & (ent_k.amax(dim=1) >= rc.LOG_EPS), (acc_k, lt_k, ent_k),
                            tag, rejected)
    err_fwd = max(float((acc_k - acc_p).abs().max()),
                  float((lt_k[~near] - lt_p[~near]).abs().max()),
                  float((ent_k[strict_seg] - ent_p[strict_seg]).abs().max()))
    n_seg = seg_tile.shape[0]
    head = (f"{tag}: {n_seg} segments ({int(in_grid.sum())} of tiles, "
            f"{int((ent_k.amax(dim=1) < rc.LOG_EPS)[in_grid].sum())} skipped), "
            f"{int(near.sum())} boundary tiles; blend_csr_fwd max_abs_err={err_fwd:.3e} "
            f"({shares['fwd']:.3f} of tolerance)")
    if not with_bwd:
        print(f"{head}; {'the stash shift and ' if shift_shows else ''}the logT scale rejected")
        return {"fwd": err_fwd, "bwd": None, "segments": segments}, (ent_k, None, None)

    g = torch.Generator(device="cuda").manual_seed(2)
    g_acc = torch.randn(acc_k.shape, generator=g, device="cuda")
    g_lt = torch.randn(lt_k.shape, generator=g, device="cuda")
    d_k = rc.blend_csr_bwd(*stream, ent_k, g_acc, g_lt, n_tiles, c)
    d_p = rc.blend_csr_bwd_plain(*stream, ent_k, g_acc, g_lt, n_tiles, c)
    col_max = d_p.abs().amax(dim=0)  # (16,)
    d_lim = REL_TOL * col_max

    def bwd_share(d):
        return check_close(f"{tag} csr bwd", d, d_p, d_lim)

    shares["bwd"] = bwd_share(d_k)
    per_col = (d_k - d_p).abs().amax(dim=0) / torch.clamp(col_max, min=1e-30)
    for col in range(6 + c):
        zeroed = d_k.clone()
        zeroed[:, col] = 0.0
        must_reject(f"csr gradient column {col} zeroed", lambda: bwd_share(zeroed))
    leak = csr_bwd_carry_leak(torch, rc, stream, ent_k, g_acc, g_lt, n_tiles)
    must_reject("carry not reset at tile boundaries", lambda: bwd_share(leak))
    csr_bwd_split_checks(torch, rc, stream, n_tiles, c, (ent_k, g_acc, g_lt), d_k, tag,
                         bwd_rejected)

    errs = {"fwd": err_fwd, "bwd": float((d_k - d_p).abs().max()), "segments": segments}
    print(f"{head}, blend_csr_bwd max_abs_err={errs['bwd']:.3e} "
          f"({shares['bwd']:.3f} of tolerance); bwd max err per column / column max: "
          + " ".join(f"{float(x):.1e}" for x in per_col[:6 + c]))
    return errs, (ent_k, g_acc, g_lt)


def random_dual_stream(torch, rc, seed: int, n_tiles: int = 256):
    """random_csr_stream with band bits in column BAND_COL: tiles 16-47
    (which saturate in the first of their three segments) carry no band bit
    in their first segment and all of them after it, so the full composite
    saturates a segment before the band does; tiles 64-127 carry none,
    128-191 all, the rest a random 30%."""
    rows, seg_tile, seg_u0, seg_v0 = random_csr_stream(torch, seed, n_tiles)
    g = torch.Generator(device="cpu").manual_seed(seed + 100)
    st = seg_tile.long().cpu()
    starts, _ = rc._tile_segments(seg_tile.cpu(), n_tiles)
    seg_rank = torch.arange(st.shape[0]) - starts.long()[st.clamp(max=n_tiles - 1)]
    tile, rank = st.repeat_interleave(rc.CSEG), seg_rank.repeat_interleave(rc.CSEG)
    bits = (torch.rand(rows.shape[0], generator=g) < 0.3).float()
    bits[(tile >= 64) & (tile < 128)] = 0.0
    bits[(tile >= 128) & (tile < 192)] = 1.0
    sat = (tile >= 16) & (tile < 48)
    bits[sat] = (rank[sat] > 0).float()
    rows[:, rc.BAND_COL] = bits.cuda()
    return rows, seg_tile, seg_u0, seg_v0


def band_rows(rc, rows):
    """The entry rows with each opacity multiplied by its band bit."""
    out = rows.clone()
    out[:, 5] *= out[:, rc.BAND_COL]
    return out


def dual_exit_on_full(torch, rc, stream, n_tiles):
    """B5's twin with one planted fault: the whole-tile exit tests the full
    carry (B3's rule) in place of the band carry, so the band stops walking
    where the full composite saturates."""
    blocks, starts, counts, px, py, ranks = rc._csr_tiles(*stream, n_tiles)
    accum = stream[0].new_zeros((n_tiles, rc.PX, rc.MAX_CHANNELS))
    logt = stream[0].new_zeros((n_tiles, rc.PX))
    logt_band = stream[0].new_zeros((n_tiles, rc.PX))
    for r in range(ranks):
        act = torch.nonzero(counts > r).squeeze(1)
        act = act[logt[act].amax(dim=1) >= rc.LOG_EPS]
        seg = starts[act].long() + r
        accum[act], logt[act], logt_band[act] = rc._dual_segment(
            blocks[seg], px[act], py[act], accum[act], logt[act], logt_band[act]
        )
    return accum[:, :, :DUAL_CHANNELS].contiguous(), logt, logt_band


def dual_kernel_checks(torch, rc, stream, n_tiles: int, tag: str, rejected,
                       require_exit_fault=True):
    """B5 against its twin on one CSR stream with band bits, with B3's
    tolerances: a tile is a boundary tile when the band carry's max logT at
    one of its segment starts (B3's stash over the band rows, kernel and
    twin) lies within BOUNDARY of LOG_EPS. Then the two bitwise identities:
    the band carry equals B3's logT over the band rows, and with every band
    bit set (accum, logT) equal B3's and the band carry the full one.
    Planted faults (the exit tested on the full carry, the band column
    ignored, the band read from column 15, logT_band scaled by 1.001) must be
    rejected; the first shows only on a stream where the full composite
    saturates a segment before the band, which `require_exit_fault` demands.
    Each pass of B5 is held against its plain version (split_checks, which
    counts the planted faults it rejects in `rejected`). Returns (max abs
    error, the band stash, the band rows, (segments computed, walked))."""
    c = DUAL_CHANNELS
    seg_tile = stream[1]
    acc_k, lt_k, lb_k = rc.blend_csr_dual_fwd(*stream, n_tiles, c)
    acc_p, lt_p, lb_p = rc.blend_csr_dual_fwd_plain(*stream, n_tiles, c)
    banded = band_rows(rc, stream[0])
    _, b3_lt, ent_k = rc.blend_csr_fwd(banded, *stream[1:], n_tiles, c, with_entry=True)
    _, _, ent_p = rc.blend_csr_fwd_plain(banded, *stream[1:], n_tiles, c, with_entry=True)
    in_grid = seg_tile < n_tiles
    seg_near = ((torch.stack([ent_k, ent_p]).amax(dim=2) - rc.LOG_EPS).abs() < BOUNDARY).any(dim=0)
    near = torch.zeros(n_tiles + 1, dtype=torch.bool, device="cuda")
    near[seg_tile[seg_near & in_grid].long()] = True
    near = near[:n_tiles]
    # pairs at the alpha threshold among the walked rows, and among the band's
    walk = in_grid & (ent_k.amax(dim=1) >= rc.LOG_EPS)
    edge = threshold_logt_allowance(torch, rc, stream, walk, n_tiles)
    edge_band = threshold_logt_allowance(torch, rc, (banded, *stream[1:]), walk, n_tiles)

    def shares(acc, lt, lb):
        chan = acc_p.abs().amax(dim=(0, 1))
        acc_lim = (REL_TOL + (SKIP_ATOL - REL_TOL) * near.float())[:, None, None] * chan
        out = [check_close(f"{tag} dual accum", acc, acc_p, acc_lim)]
        for what, got, want, allow in (("logT", lt, lt_p, edge), ("band logT", lb, lb_p, edge_band)):
            out.append(check_close(f"{tag} dual {what}", got[~near], want[~near],
                                   LOGT_ATOL + REL_TOL * want[~near].abs() + allow[~near]))
            out.append(check_close(f"{tag} dual {what} (boundary tiles)", got[near].exp(),
                                   want[near].exp(), torch.tensor(SKIP_ATOL)))
        return max(out)

    share = shares(acc_k, lt_k, lb_k)
    ones = stream[0].clone()
    ones[:, rc.BAND_COL] = 1.0
    acc_1, lt_1, lb_1 = rc.blend_csr_dual_fwd(ones, *stream[1:], n_tiles, c)
    acc_3, lt_3 = rc.blend_csr_fwd(ones, *stream[1:], n_tiles, c)
    if not torch.equal(lb_k, b3_lt):
        raise AssertionError(f"{tag}: band logT is not bitwise B3's logT over the band rows")
    if not (torch.equal(acc_1, acc_3) and torch.equal(lt_1, lt_3) and torch.equal(lb_1, lt_1)):
        raise AssertionError(f"{tag}: with every band bit set B5 is not bitwise B3")
    col15 = stream[0].clone()
    col15[:, rc.BAND_COL] = col15[:, 15]
    # the exit fault shows only where the full composite saturates a
    # segment before the band; the random stream is built to have such tiles
    exit_fault = dual_exit_on_full(torch, rc, stream, n_tiles)
    exit_shows = not all(torch.equal(a, b) for a, b in zip(exit_fault, (acc_p, lt_p, lb_p)))
    if exit_shows:
        must_reject("exit tested on the full carry", lambda: shares(*exit_fault))
    elif require_exit_fault:
        raise AssertionError(f"{tag}: no tile saturates its full composite before its band")
    must_reject("band column ignored", lambda: shares(acc_1, lt_1, lb_1))
    must_reject("band read from column 15",
                lambda: shares(*rc.blend_csr_dual_fwd(col15, *stream[1:], n_tiles, c)))
    must_reject("band logT scaled by 1.001", lambda: shares(acc_k, lt_k, lb_k * 1.001))
    segments = split_checks(torch, rc, stream, n_tiles, c, True,
                            in_grid & (ent_k.amax(dim=1) >= rc.LOG_EPS), (acc_k, lt_k, lb_k),
                            tag, rejected)
    err = max(float((acc_k - acc_p).abs().max()), float((lt_k[~near] - lt_p[~near]).abs().max()),
              float((lb_k[~near] - lb_p[~near]).abs().max()))
    print(f"{tag}: {seg_tile.shape[0]} segments ({int(in_grid.sum())} of tiles, "
          f"{int((ent_k.amax(dim=1) < rc.LOG_EPS)[in_grid].sum())} skipped by the band exit), "
          f"{int(near.sum())} boundary tiles; blend_csr_dual_fwd max_abs_err={err:.3e} "
          f"({share:.3f} of tolerance); both identities bitwise; {3 + exit_shows} planted faults "
          f"rejected")
    return err, ent_k, banded, segments


def dual_pair_counts(torch, rc, stream, entry, n_tiles):
    """(walked segments, walked pairs, live pairs, band-live pairs) of B5 on
    a CSR stream: the segments the band exit walks (from B3's stash over the
    band rows), their (row, pixel) pairs, those whose alpha is not zero, and
    those among them whose row carries the band bit."""
    data, seg_tile, seg_u0, seg_v0 = stream
    walked_seg = (seg_tile < n_tiles) & (entry.amax(dim=1) >= rc.LOG_EPS)
    blocks = data.view(-1, rc.CSEG, rc.N_ATTR)
    live = band_live = 0
    for chunk in torch.nonzero(walked_seg).squeeze(1).split(64):
        px, py = rc._pixel_coords(seg_u0[chunk], seg_v0[chunk])
        live_c = rc._segment_geometry(blocks[chunk], px, py)[5]
        live += int(live_c.sum())
        band_live += int((live_c & (blocks[chunk][:, :, rc.BAND_COL:rc.BAND_COL + 1] > 0)).sum())
    n_walked = int(walked_seg.sum())
    return n_walked, n_walked * rc.CSEG * rc.PX, live, band_live


def capture_streams(blend: str, run):
    """The CSR streams that one call of `run` hands to the rasterizer's
    `blend` (blend_csr for B3, blend_csr_dual_fwd for B5), one per call:
    [((entry rows, seg_tile, seg_u0, seg_v0), n_tiles, n_channels), ...]."""
    from activesplat_tpu_torch.ops import raster_tiled

    seen = []
    real = getattr(raster_tiled, blend)
    setattr(raster_tiled, blend, lambda *a: seen.append(a) or real(*a))
    try:
        run()
    finally:
        setattr(raster_tiled, blend, real)
    return [((rows.detach().contiguous(), seg_tile, seg_u0, seg_v0), n_tiles, c)
            for rows, seg_tile, seg_u0, seg_v0, n_tiles, c in seen]


def query_pose(np, center):
    """bench.py's camera orientation (looking down -z) at `center`."""
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = center
    return c2w


def small_query_check(torch, np):
    """The port on the card against the port on the CPU (plain twins) on a
    small scene (4,000 Gaussians of a single room): render_topdown's maps
    equal but for pixels within 1e-5 of the 0.4 threshold, its free alpha
    within 1e-5, and render_panorama's rgb, depth and invisibility within
    1e-5 (the two differ in summation order only)."""
    from activesplat_tpu_torch.models.gaussians import GaussianBuffer
    from activesplat_tpu_torch.queries.panorama import render_panorama
    from activesplat_tpu_torch.queries.topdown import render_topdown, topdown_config_from_bbox
    from activesplat_tpu_torch.runtime.synthetic import BoxWorld

    world = BoxWorld.single_room(seed=3)
    pts = torch.from_numpy(world.sample_surface(4000, seed=3).astype(np.float32))
    sx, sy, sz = world.size
    cfg = topdown_config_from_bbox(np.array([[0, sx], [0, sy], [0, sz]]), 0.1, 1.6, pixel_max=96,
                                   padding_ratio=0.02)
    out = {}
    for dev in ("cpu", "cuda"):
        buf = GaussianBuffer.empty(4096, device=dev)
        n = len(pts)
        buf.params.means3d[:n] = pts.to(dev)
        buf.params.rgb[:n] = 0.5
        buf.params.logit_opacities[:n] = 4.0
        buf.params.log_scales[:n] = float(np.log(0.08))
        buf.active[:n] = True
        free, unobs, alpha = render_topdown(buf, cfg)
        out[dev] = (np.stack([free, unobs]), alpha.cpu().numpy(),
                    render_panorama(buf, query_pose(np, [sx / 2, 1.25, sz / 2]), scale=0.5))
    (maps_c, alpha_c, pano_c), (maps_g, alpha_g, pano_g) = out["cpu"], out["cuda"]
    differ = maps_c != maps_g
    near = np.zeros_like(differ)
    near[0] = np.abs(alpha_g - 0.4) < 1e-5
    worst = max([float(np.abs(alpha_c - alpha_g).max())]
                + [float(np.abs(a - b).max()) for a, b in zip(pano_c, pano_g)])
    if (differ & ~near).any() or worst > 1e-5:
        raise AssertionError(f"small query scene: {int((differ & ~near).sum())} map pixels differ, "
                             f"max value difference {worst:.3e}")
    print(f"small query scene: top-down maps equal ({int(differ.sum())} threshold-adjacent pixels "
          f"differ), free alpha and panorama within {worst:.3e} of the port on the CPU")


def main_path_rows(torch, buf, cam, k):
    """The blend kernels' inputs for one training render of the map at
    k_per_tile `k`."""
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
            width=cam.width, height=cam.height, k_per_tile=k,
        )
    return rows.contiguous(), u0, v0


def main_path_csr(torch, buf, cam):
    """The CSR blend kernels' inputs for one exact render of the map: the
    stream (entry_data, seg_tile, seg_u0, seg_v0) and the tile count."""
    from activesplat_tpu_torch.ops.projection import adaptive_cull_radius, project_gaussians
    from activesplat_tpu_torch.ops.raster_tiled import csr_rows

    p = buf.params
    with torch.no_grad():
        proj = project_gaussians(
            p.means3d, p.quats, p.log_scales, buf.active, cam.w2c,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        )
        opac = torch.sigmoid(p.logit_opacities)
        radius, valid = adaptive_cull_radius(proj.radius, proj.valid, opac)
        colors = torch.cat([p.rgb, proj.depth[:, None], (proj.depth ** 2)[:, None]], -1)
        data, seg_tile, seg_u0, seg_v0, dropped = csr_rows(
            proj.mean2d, proj.conic, opac, colors, valid, radius, proj.depth,
            width=cam.width, height=cam.height,
        )
    if dropped:
        raise AssertionError(f"the main path's exact render passed the entry budget by {dropped}")
    return (data.contiguous(), seg_tile, seg_u0, seg_v0), (-(-cam.width // 16)) * (-(-cam.height // 16))


def csr_pair_counts(torch, rc, stream, entry, n_tiles):
    """(walked segments, walked pairs, live pairs) of a CSR stream: the
    (row, pixel) pairs of the segments the forward walks, and those among
    them whose alpha is not zero."""
    data, seg_tile, seg_u0, seg_v0 = stream
    walked_seg = (seg_tile < n_tiles) & (entry.amax(dim=1) >= rc.LOG_EPS)
    blocks = data.view(-1, rc.CSEG, rc.N_ATTR)
    live = 0
    for chunk in torch.nonzero(walked_seg).squeeze(1).split(64):
        px, py = rc._pixel_coords(seg_u0[chunk], seg_v0[chunk])
        live += int(rc._segment_geometry(blocks[chunk], px, py)[5].sum())
    n_walked = int(walked_seg.sum())
    return n_walked, n_walked * rc.CSEG * rc.PX, live


def pair_counts(torch, rc, rows, u0, v0, entry):
    """(walked, live, live warp-rows): the (row, pixel) pairs of the segments
    the forward walks, those among them whose alpha is not zero, and the
    (row, warp) pairs of B2's walk that hold a live pair (a warp takes an
    8x4-pixel block of its tile)."""
    walked_seg = entry.amax(dim=2) >= rc.LOG_EPS  # (T, K/SEG)
    px, py = rc._pixel_coords(u0, v0)
    live = live_wr = 0
    for s in range(walked_seg.shape[1]):
        block = rows[:, s * rc.SEG:(s + 1) * rc.SEG]
        live_s = rc._segment_geometry(block, px, py)[5] & walked_seg[:, s, None, None]  # (T, SEG, PX)
        live += int(live_s.sum())
        # pixels y * 16 + x as (T, SEG, 4 block rows, 4 y, 2 block columns, 8 x)
        live_wr += int(live_s.view(*live_s.shape[:2], 4, 4, 2, 8).any(dim=5).any(dim=3).sum())
    return int(walked_seg.sum()) * rc.SEG * rc.PX, live, live_wr


def small_scene_check(torch, np, exact_training="off", k_per_tile=64):
    """The port on the card against the port on the CPU (plain twins): loss
    and gradients of mapping_loss on a small random scene. Tolerance: the
    two differ in summation order only (and the SSIM matmuls' blocking), so
    1e-4 relative to each gradient's scale. At k_per_tile=16 the cap bites,
    so "hybrid" recomposites tiles with the CSR blend."""
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
    cfg = MapperConfig(k_per_tile=k_per_tile, exact_training=exact_training)
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
    tag = f"small scene, exact_training={exact_training!r}, k={k_per_tile}"
    if worst > 1e-4:
        raise AssertionError(f"{tag}: gradients differ: {worst:.3e} of scale")
    print(f"{tag}: loss cuda {float(l_gpu):.7f} cpu {float(l_cpu):.7f}, "
          f"max grad err {worst:.3e} of scale")


def random_bin_scene(torch, n: int, w: int, h: int):
    """tests/test_raster_tiled.py:324-332's bin inputs on the card: n splats
    with means over the image and 20 px beyond it, radii of 1 to 25 px, 85%
    valid."""
    import numpy as np

    rng = [np.random.default_rng(n + i) for i in range(3)]
    return (torch.tensor(rng[0].uniform(-20, max(w, h) + 20, (n, 2)), dtype=torch.float32).cuda(),
            torch.tensor(rng[1].uniform(1, 25, n), dtype=torch.float32).cuda(),
            torch.from_numpy(rng[2].uniform(0, 1, n) > 0.15).cuda(), w, h)


def bin_fault(torch, rc, indices, args, fault):
    """B6's output with one planted fault. "slot off by one": the twin's
    search for slot s + 1. "members before the slot counted from its own
    block": with cum[b] in place of cum[b - 1] a slot's rank in its block
    is negative, so it lands on the block's first Gaussian. "sentinel
    replaced by the window's last member": past a tile's count, the last
    member of its window in place of n."""
    cum, aabb, k, off, tiles_x, n = args
    if fault == BIN_FAULTS[0]:
        return rc.bin_slots_plain(cum, aabb, k, off + 1, tiles_x, n)
    if fault == BIN_FAULTS[1]:
        return torch.where(indices < n, indices - indices % rc.BIN_BLOCK, indices)
    filled = (cum[-1][:, None].long() - off).clamp(0, k)  # (T, 1) members in the window
    last = indices.gather(1, (filled - 1).clamp(min=0))
    past = torch.arange(k, device=indices.device)[None, :] >= filled
    return torch.where(past & (filled > 0), last, indices)


def slot_pass_model(torch, cum_t, words, k, off, tiles_x, n, fault=None):
    """The slot pass's algorithm in PyTorch, with the sentinel tail: every
    (block, tile) pair in the window (hi > lo, lo < off + k, hi > off)
    ranks the block's members of the tile by four ballots of 32 lanes,
    popcount below the lane plus the members of the groups before it, and
    writes each member whose slot lo + rank - off lies in [0, k); slots
    that no thread writes keep -1. `fault`, one of BIN_SPLIT_FAULTS[2:]:
    the members ranked from the last lane down, or the window tested with
    lo >= off in place of hi > off."""
    nb, t = cum_t.shape
    lo = torch.nn.functional.pad(cum_t, (0, 0, 1, 0))[:-1]  # cum[b - 1], 0 for b = 0
    start = lo >= off if fault == BIN_SPLIT_FAULTS[3] else cum_t > off
    blk, tile = torch.nonzero((cum_t > lo) & (lo < off + k) & start, as_tuple=True)
    w = words.view(nb, 4, 32)[blk]  # (pairs, group, lane)
    ttx = (tile % tiles_x)[:, None, None]
    tty = (tile // tiles_x)[:, None, None]
    member = ((((w >> 24) & 0xFF) <= ttx) & (ttx <= ((w >> 16) & 0xFF))
              & (((w >> 8) & 0xFF) <= tty) & (tty <= (w & 0xFF)))
    if fault == BIN_SPLIT_FAULTS[2]:
        member = member.flip((1, 2))
    bits = member.to(torch.int32)
    below = torch.cumsum(bits, 2) - bits  # popcount below the lane
    groups = torch.cumsum(bits.sum(2), 1) - bits.sum(2)  # members of the earlier groups
    rank = below + groups[:, :, None]
    if fault == BIN_SPLIT_FAULTS[2]:
        rank, member = rank.flip((1, 2)), member.flip((1, 2))
    slot = lo[blk, tile][:, None, None] + rank - off
    write = member & (slot >= 0) & (slot < k)
    ids = blk[:, None, None] * 128 + torch.arange(128, device=w.device).view(1, 4, 32)
    out = torch.full((t, k), -1, dtype=torch.int64, device=cum_t.device)
    out[tile[:, None, None].expand_as(slot)[write], slot[write]] = ids.expand_as(slot)[write]
    past = off + torch.arange(k, device=cum_t.device)[None, :] >= cum_t[-1][:, None]
    return torch.where(past, n, out)


def bin_split_checks(torch, rc, count_args, slot_args, tag, rejected):
    """B6's two passes against their plain versions, bitwise, on the inputs
    that the route handed them: the count pass's words and counts against
    bin_count_plain's; the cumsum of its counts is what the route handed
    the slot pass; the slot pass fed it against bin_slots_plain and the
    torch model of its algorithm; both passes repeat bitwise. Each planted
    fault that changes the output must be rejected; `rejected` counts
    them. Returns the kernel's (words, counts, ids)."""
    words, counts = rc.bin_count_cuda(*count_args)
    p_words, p_counts = rc.bin_count_plain(*count_args)

    def same_counts(cand_counts, cand_words=p_words):
        for what, got, want in (("words", words, cand_words), ("counts", counts, cand_counts)):
            if not torch.equal(got, want):
                raise AssertionError(f"{tag}: the count pass's {what} differ from its plain "
                                     f"version's at {int((got != want).sum())} entries")

    same_counts(p_counts)
    cum_t = torch.cumsum(counts, 0, dtype=torch.int32)
    if not (torch.equal(cum_t, slot_args[0]) and torch.equal(words, slot_args[1])):
        raise AssertionError(f"{tag}: the route handed the slot pass other inputs than the "
                             f"count pass gives")
    tail = slot_args[2:]
    ids = rc.bin_slots_cuda(cum_t, words, *tail)
    plain = rc.bin_slots_plain(cum_t, words, *tail)

    def same_ids(cand):
        if not torch.equal(ids, cand):
            raise AssertionError(f"{tag}: the slot pass differs from its plain version at "
                                 f"{int((ids != cand).sum())} slots")

    same_ids(plain)
    same_ids(slot_pass_model(torch, cum_t, words, *tail))
    again = rc.bin_count_cuda(*count_args)
    if not (torch.equal(again[0], words) and torch.equal(again[1], counts)
            and torch.equal(rc.bin_slots_cuda(cum_t, words, *tail), ids)):
        raise AssertionError(f"{tag}: a repeated pass differs")
    valid, tx0, tx1, ty0, ty1, tiles_x, tiles_y = count_args
    pad = words.numel() - valid.numel()
    padded = p_counts.clone()
    padded[-1, 0] += pad  # the padding words' tx0 = 255 read as 0: members of tile 0
    candidates = {
        BIN_SPLIT_FAULTS[0]: (same_counts, rc.bin_count_plain(valid, tx0, tx1 + 1, ty0, ty1,
                                                               tiles_x, tiles_y)[1], counts),
        BIN_SPLIT_FAULTS[1]: (same_counts, padded, counts),
        BIN_SPLIT_FAULTS[2]: (same_ids, slot_pass_model(torch, cum_t, words, *tail,
                                                        fault=BIN_SPLIT_FAULTS[2]), ids),
        BIN_SPLIT_FAULTS[3]: (same_ids, slot_pass_model(torch, cum_t, words, *tail,
                                                        fault=BIN_SPLIT_FAULTS[3]), ids),
    }
    for fault, (check, bad, good) in candidates.items():
        if not torch.equal(bad, good):
            must_reject(fault, lambda: check(bad))
            rejected[fault] += 1
    return words, counts, ids


def bin_checks(torch, rc, rt, scene, k: int, offsets, tag: str, rejected, split_rejected):
    """B6 on the passes that bin_gaussians' kernel route hands its two
    wrappers for `scene` at each slot offset: each pass against its plain
    version (bin_split_checks), the route's ids bitwise against
    bin_slots_plain's, and the route's lists (indices, count, overflow)
    bitwise against the sort route's. Each planted fault that changes the
    output must be rejected; `rejected` and `split_rejected` count them.
    Returns [(offset, the count pass's arguments, the slot pass's, lists)]."""
    mean2d, radius, valid, w, h = scene
    out = []
    for off in offsets:
        seen_count, seen = [], []
        real_count, real = rt.bin_count, rt.bin_slots
        rt.bin_count = lambda *a: seen_count.append(a) or real_count(*a)
        rt.bin_slots = lambda *a: seen.append(a) or real(*a)
        try:
            lists = rt.bin_gaussians(mean2d, radius, valid, w, h, k, off, use_kernel=True)
        finally:
            rt.bin_count, rt.bin_slots = real_count, real
        if len(seen) != 1 or len(seen_count) != 1:
            raise AssertionError(f"{tag}: the kernel route did not run at offset {off}")
        count_args, args = seen_count[0], seen[0]
        bin_split_checks(torch, rc, count_args, args, f"{tag} k={k} offset {off}", split_rejected)
        plain = rc.bin_slots_plain(*args)

        def same(idx):
            if not torch.equal(idx, plain):
                raise AssertionError(f"{tag} k={k} offset {off}: bin_slots differs from its twin "
                                     f"at {int((idx != plain).sum())} slots")

        same(lists.indices)
        sort = rt.bin_gaussians(mean2d, radius, valid, w, h, k, off, use_kernel=False)
        for f in ("indices", "count", "overflow"):
            if not torch.equal(getattr(lists, f), getattr(sort, f)):
                raise AssertionError(f"{tag} k={k} offset {off}: the kernel route's {f} differ "
                                     f"from the sort route's")
        shown = []
        for fault in BIN_FAULTS:
            bad = bin_fault(torch, rc, lists.indices, args, fault)
            if not torch.equal(bad, lists.indices):
                must_reject(fault, lambda: same(bad))
                rejected[fault] += 1
                shown.append(fault)
        n = args[5]
        print(f"{tag} k={k} offset {off}: {args[0].shape[0]} blocks, "
              f"{int((lists.indices < n).sum())} of {lists.indices.numel()} slots filled; each "
              f"pass bitwise equal to its plain version, the route to the twin and the sort route; "
              f"{len(shown)} planted faults of the output rejected")
        out.append((off, count_args, args, lists))
    return out


def bin_bound(torch, rc, count_args, args, counts, indices, int_rate: float):
    """B6's bound on these inputs, pass by pass, each the larger of its
    bytes at the HBM rate and its integer operations at the INT32 rate.
    The count pass: its inputs read once (a bool and four float32 bounds a
    Gaussian), the words and counts written; one increment per (Gaussian,
    tile of its rectangle). The slot pass: the words of every block that
    holds a filled slot, the two cum entries of every (tile, block) pair
    that holds one, the int64 output; four compares per Gaussian of each
    such pair and one per slot. The entry's bound is the two passes'
    summed. Also the slot-search formula of the earlier kernel (the tile rows of cum,
    the words of every block a filled slot lands in and the output; per
    filled slot a block search, ceil(log2 nb) + 1 compares, and four
    compares for each of the block's 128 members; per empty slot one
    compare). Returns {"count", "slot", "old": (ms, by, bytes, ops)}."""
    cum_t, aabb, k, off, tiles_x, n = args
    nb, t = cum_t.shape
    filled = indices < n
    n_filled = int(filled.sum())
    blk = indices[filled] // rc.BIN_BLOCK
    tile = torch.nonzero(filled, as_tuple=True)[0]
    n_pairs = int(torch.unique(tile * nb + blk).numel())
    n_blocks = int(torch.unique(blk).numel())
    n_gauss = count_args[0].numel()

    def timed(nbytes, ops):
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / int_rate * 1e3}
        by = max(times, key=times.get)
        return times[by], by, nbytes, ops

    return {
        "count": timed(n_gauss * (1 + 4 * 4) + aabb.numel() * 4 + counts.numel() * 4,
                       int(counts.sum())),
        "slot": timed(n_blocks * rc.BIN_BLOCK * 4 + n_pairs * 8 + indices.numel() * 8,
                      n_pairs * rc.BIN_BLOCK * 4 + t * k),
        "old": timed(cum_t.numel() * 4 + n_blocks * rc.BIN_BLOCK * 4 + indices.numel() * 8,
                     n_filled * (math.ceil(math.log2(nb)) + 1 + 4 * rc.BIN_BLOCK)
                     + (t * k - n_filled)),
        "filled": n_filled, "pairs": n_pairs, "blocks": n_blocks,
    }


def print_bin_bound(bb, tag, ms, card):
    """One line: each pass's bound and its share reached, and the
    slot-search formula's."""
    parts = []
    for name in ("count", "slot", "old"):
        b_ms, by, nbytes, ops = bb[name]
        label = {"count": "count pass", "slot": "slot pass",
                 "old": "the slot-search formula"}[name]
        reached = ms[name] if name != "old" else ms["slot"]
        parts.append(f"{label} {b_ms:.5f} ms ({by}: {nbytes} bytes, {ops} integer operations; "
                     f"{b_ms / reached:.3f} of it reached by the {'slot' if name == 'old' else name}"
                     f" pass's {reached:.4f} ms)")
    print(f"{tag}: {bb['filled']} slots filled from {bb['pairs']} (tile, block) pairs, "
          f"{bb['blocks']} blocks; bound " + "; ".join(parts) + f" on {card}")


def b6_calls(torch, rc, count_args, args):
    """B6's wrapper calls from the count pass's inputs to the slot pass's
    ids, and the same through their plain versions: (run, plain)."""
    tail = args[2:]

    def chain(count, slots):
        words, counts = count(*count_args)
        return slots(torch.cumsum(counts, 0, dtype=torch.int32), words, *tail)

    return (lambda: chain(rc.bin_count, rc.bin_slots),
            lambda: chain(rc.bin_count_plain, rc.bin_slots_plain))


def b6_bound_ms(bb):
    """The B6 entry's bound: the two passes' bounds summed, and what binds
    the larger."""
    larger = max(("count", "slot"), key=lambda p: bb[p][0])
    return bb["count"][0] + bb["slot"][0], f"{larger} pass: {bb[larger][1]}"


def gather_bwd_inputs(torch, seed: int, shape, n: int):
    """(grad, ids) of one row gather's backward into an (n + 1)-row table:
    random ids, GATHER_PAD_SHARE of them the padding row n, and row 7 once
    in every list (a Gaussian in every tile: a run as long as the lists
    are many); the gradient the live columns of 16-wide rows, as the
    blends hand it back (strided, not copied)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, n, shape, generator=g, device="cuda")
    ids = torch.where(torch.rand(shape, generator=g, device="cuda") < GATHER_PAD_SHARE, n, ids)
    if len(shape) == 2:
        ids[:, 0] = 7
    else:
        ids[::GATHER_CAPPED[1]] = 7
    grad = torch.randn(shape + (16,), generator=g, device="cuda")[..., :GATHER_WIDTH]
    return grad, ids


def gather_bwd_checks(torch, rc, card) -> dict:
    """The row gathers' backward on the card against the library's index
    backward, on a capped call and a CSR stream at 512x512: rows below the
    padding row bitwise equal, the padding row zero, two calls bitwise
    equal, the launches counted; timed (the kernel by torch.profiler, the
    wrapper with its sort and the library's call between CUDA events) beside
    the bound, the bytes moved over HBM_BYTES_PER_S."""
    n = GATHER_TABLE_ROWS
    out = {"name": "gather_rows_bwd", "file": "activesplat_tpu_torch/csrc/gather_bwd.cu",
           "inputs": {}}
    for tag, shape in (("capped", GATHER_CAPPED), ("csr", (GATHER_CSR_ROWS,))):
        grad, ids = gather_bwd_inputs(torch, len(shape), shape, n)
        if tag == "csr":
            grad = grad.contiguous()  # the other layout the wrapper reads in place
        before = rc.gather_rows_bwd.launches
        got = rc.gather_rows_bwd(grad, ids, n + 1)
        again = rc.gather_rows_bwd(grad, ids, n + 1)
        lib = torch.ops.aten._index_put_impl_(grad.new_zeros((n + 1, GATHER_WIDTH)), [ids], grad,
                                              True, True)
        if rc.gather_rows_bwd.launches - before != 2:
            raise AssertionError(f"gather_rows_bwd ({tag}): "
                                 f"{rc.gather_rows_bwd.launches - before} launches for 2 calls")
        if not torch.equal(got[:n], lib[:n]):
            gap = float((got[:n] - lib[:n]).abs().max())
            rows = int((got[:n] != lib[:n]).any(1).sum())
            raise AssertionError(f"gather_rows_bwd ({tag}): {rows} rows below the padding row "
                                 f"differ from _index_put_impl_, by up to {gap:.3e}")
        if got[n].any():
            raise AssertionError(f"gather_rows_bwd ({tag}): the padding row is not zero")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"gather_rows_bwd ({tag}): two calls differ")
        r = ids.numel()
        pad = int((ids == n).sum())
        longest = int(torch.bincount(ids.reshape(-1))[:n].max())
        nbytes = r * GATHER_WIDTH * 4 + r * 8 + (n + 1) * GATHER_WIDTH * 4
        kernel_ms = kernel_device_ms(torch, lambda: rc.gather_rows_bwd(grad, ids, n + 1),
                                     ("gather_rows_bwd_kernel",), 20)["gather_rows_bwd_kernel"]
        entry = {
            "rows": r, "pad_rows": pad, "longest_run": longest, "table_rows": n + 1,
            "ms": kernel_ms,
            "wrapper_ms": cuda_ms(lambda: rc.gather_rows_bwd(grad, ids, n + 1), 20),
            "runs_ms": cuda_ms(lambda: rc.gather_bwd_runs(ids, n + 1), 20),
            "library_ms": cuda_ms(lambda: torch.ops.aten._index_put_impl_(
                grad.new_zeros((n + 1, GATHER_WIDTH)), [ids], grad, True, True), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        print(f"gather_rows_bwd ({tag}: {r} rows, {pad} of them the padding row, longest other "
              f"run {longest}, into {n + 1} table rows): rows below the padding row bitwise "
              f"_index_put_impl_'s, the padding row zero, two calls bitwise equal; kernel "
              f"{entry['ms']:.4f} ms, wrapper {entry['wrapper_ms']:.4f} ms (the ids' sort and "
              f"runs {entry['runs_ms']:.4f}), bound {entry['bound_ms']:.4f} ms (bytes, "
              f"{entry['bound_ms'] / entry['ms']:.3f} of it reached), library "
              f"{entry['library_ms']:.4f} ms on {card}")
        out["inputs"][tag] = entry
        del grad, ids, got, again, lib
    torch.cuda.synchronize()
    return out


def small_driver_check(torch, np, world, res: int = 64, frames: int = 5) -> None:
    """The driver on the card (kernels) against the driver on the CPU
    (plain twins) over the first frames of driver_frames' walk at 64x64:
    the same slots and Gaussian count; metrics within 1e-4 relative;
    parameters within 1e-4 but for at most 0.1% of them, each within two
    learning rates per Adam step (both blends exit a saturated
    tile early, and a segment at the exit threshold may be walked on one
    side only: its Gaussians' zero-versus-tiny gradients become whole Adam
    steps, tests/test_torch_splatam.py)."""
    import dataclasses

    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper

    intr = driver_intrinsics(np, res)
    stream = driver_frames(np, world, intr, frames, res)
    cfg = MapperConfig(initial_capacity=1 << 13, keyframe_capacity=16)
    out = {}
    for dev in ("cpu", "cuda"):
        m = SplaTAMMapper(cfg, res, res, intr, DRIVER_STEP_NUM, device=dev)
        for batch in stream:
            m.run(batch)
        out[dev] = m
    a, b = out["cpu"], out["cuda"]
    steps = a.mapping_iter_time_count
    lrs = dataclasses.asdict(cfg.lrs)
    worst = 0.0
    same = (torch.equal(a.buf.active, b.buf.active.cpu())
            and torch.equal(a.buf.timestep, b.buf.timestep.cpu())
            and a.map_version == b.map_version and a.shape_history == b.shape_history)
    for f, x, y in zip(("means3d", "rgb", "quats", "logit_opacities", "log_scales"),
                       a.buf.params.tensors(), b.buf.params.tensors()):
        err = (x - y.cpu()).abs()
        off = err > 1e-4 + 1e-4 * x.abs()
        worst = max(worst, float(err.max()))
        same = same and float(off.float().mean()) <= 1e-3 and bool((err[off] <= 2 * steps * lrs[f]).all())
    for key, v in a.last_metrics.items():
        same = same and abs(b.last_metrics[key] - v) <= 1e-4 * abs(v) + 1e-6
    if not same:
        raise AssertionError(f"small driver: the card's map or metrics differ from the CPU's "
                             f"(max parameter difference {worst:.3e}; {a.last_metrics} vs "
                             f"{b.last_metrics})")
    print(f"small driver ({frames} frames at {res}x{res}, {steps} mapping iterations): the card's "
          f"map equals the CPU's slot for slot, parameters within {worst:.3e}, metrics within 1e-4")


@contextlib.contextmanager
def recorded_targets(planner_fsm):
    """For the run inside the block, each target the planner plans: its
    tick, the index of the pose it was planned from in visited_px (the
    actions taken by then) and its exact pixel position (the decision log
    rounds it to 0.1 px)."""
    targets, real_log = [], planner_fsm.PlannerFSM._log

    def log(self, event, **fields):
        real_log(self, event, **fields)
        if event == "target":
            targets.append((self._tick_count, len(self.visited_px) - 1,
                            self.vg.vertices[fields["node"]].copy()))

    planner_fsm.PlannerFSM._log = log
    try:
        yield targets
    finally:
        planner_fsm.PlannerFSM._log = real_log


def target_timeline(np, planner, targets) -> list:
    """Each planned target (recorded_targets): the tick it was planned at,
    the actions taken by then, the agent's closest approach to it in pixels
    from then until the next target was planned, "reached" when that
    approach came within the planner's px_as_arrived, and "ended", the tick
    at which the FSM ended its navigation there (a LOCAL_REFINE begun with
    continue_global False before the next target; it does so on arrival and
    also when the target hugs an obstacle; None if it never did)."""
    out = []
    for n, (tick, pose, px) in enumerate(targets):
        nxt = targets[n + 1] if n + 1 < len(targets) else None
        until = nxt[1] + 1 if nxt else len(planner.visited_px)
        closest = float(np.min(np.linalg.norm(planner.visited_px[pose:until] - px, axis=1)))
        out.append({
            "tick": tick, "actions": pose, "px": [round(float(v), 2) for v in px],
            "closest_px": round(closest, 3), "reached": closest < planner.px_as_arrived,
            "ended": next((e["tick"] for e in planner.decision_log
                           if e["event"] == "refine_begin" and not e["continue_global"]
                           and e["tick"] > tick and (nxt is None or e["tick"] <= nxt[0])), None),
        })
    return out


def small_episode_check(torch, np, card, cpu_dir=None) -> None:
    """The port's episode on the card (kernels) against the same episode on
    the CPU (plain twins): tests/test_torch_episode.py's parity run
    (SMALL_EPISODE). The card's and the CPU's generators draw different
    keyframe picks, so both runs pick the current frame in every mapping
    iteration (torch.rand patched for the check). The CPU run must reach its
    first planned target (target_timeline), and the card's actions must equal
    the CPU's up to and including the tick at which the FSM ends its
    navigation there; if not, the tick that issued the first different action
    is printed with the two free maps' pixel difference and the two targets.
    At the end the explored free-map area is within EPISODE_AREA_RTOL and the
    Gaussian count within EPISODE_GAUSSIAN_RTOL. With `cpu_dir` the CPU run
    writes its outputs there (small_judges_check scores them)."""
    import os
    import tempfile

    from activesplat_tpu_torch.io.actions import read_actions
    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.runtime import planner_fsm
    from activesplat_tpu_torch.runtime.dataloader import RGBDSensor, SyntheticDataset
    from activesplat_tpu_torch.runtime.launch import run_episode
    from activesplat_tpu_torch.runtime.synthetic import BoxWorld

    cfg = SMALL_EPISODE
    rand, real_tick = torch.rand, planner_fsm.PlannerFSM.tick
    runs = {}
    try:
        torch.rand = lambda *a, **k: torch.full_like(rand(*a, **k), 1 - 2.0**-24)
        for dev in ("cpu", "cuda"):
            ticks = []  # (tick, actions issued so far, free map, latest target)

            def tick(self, ticks=ticks):
                real_tick(self)
                last = [e for e in self.decision_log if e["event"] == "target"][-1:]
                ticks.append((self._tick_count - 1, len(self.visited_px) - 1,
                              None if self.free_map is None else self.free_map.copy(),
                              last[0]["node_px"] if last else None))

            planner_fsm.PlannerFSM.tick = tick
            keep = dev == "cpu" and cpu_dir is not None
            with contextlib.nullcontext(cpu_dir) if keep else tempfile.TemporaryDirectory() as tmp:
                np.random.seed(0)  # the Voronoi sampling jitter's global stream
                sensor = RGBDSensor.from_fov(cfg["res"], cfg["res"], 90.0, depth_min=0.0,
                                             depth_max=10.0)
                ds = SyntheticDataset(BoxWorld.single_room(seed=2), sensor, step_num=cfg["steps"],
                                      start_position=np.array(cfg["start"]),
                                      turn_angle_deg=cfg["turn"], tilt_angle_deg=15.0,
                                      results_dir=tmp, scene_id="small")
                with recorded_targets(planner_fsm) as targets:
                    node, planner = run_episode(ds, tmp,
                                                mapper_cfg=MapperConfig(**SMALL_EPISODE_CFG),
                                                pixel_max=56, max_ticks=300, pano_scale=0.4,
                                                device=dev)
                runs[dev] = {"actions": read_actions(os.path.join(tmp, "actions.txt")),
                             "timeline": target_timeline(np, planner, targets), "ticks": ticks,
                             "gaussians": node.mapper.num_gaussians(),
                             "area": np.count_nonzero(planner.free_map)
                             * planner.topdown_cfg.meter_per_pixel ** 2}
    finally:
        torch.rand, planner_fsm.PlannerFSM.tick = rand, real_tick
    a, b = runs["cpu"], runs["cuda"]
    first = a["timeline"][0] if a["timeline"] else None
    if first is None or not first["reached"] or first["ended"] is None:
        raise AssertionError(f"small episode: the CPU run did not reach a first target and end "
                             f"its navigation there: {a['timeline']}")
    arrived = first["ended"]
    k = next(n for t, n, _, _ in a["ticks"] if t == arrived)
    if b["actions"][:k] != a["actions"][:k]:
        i = next(j for j in range(k) if a["actions"][j] != b["actions"][j])
        ta = next(r for r in a["ticks"] if r[1] > i)
        tb = next(r for r in b["ticks"] if r[0] == ta[0])
        diff = None if ta[2] is None or tb[2] is None else int((ta[2] != tb[2]).sum())
        raise AssertionError(f"small episode: action {i} differs (CPU {a['actions'][i]}, card "
                             f"{b['actions'][i]}), issued at tick {ta[0]}: the free maps differ "
                             f"in {diff} pixels, targets CPU {ta[3]} card {tb[3]}")
    if not b["timeline"] or not b["timeline"][0]["reached"]:
        raise AssertionError(f"small episode: the card's run did not reach its first target: "
                             f"{b['timeline']}")
    if (abs(b["area"] - a["area"]) > EPISODE_AREA_RTOL * a["area"]
            or abs(b["gaussians"] - a["gaussians"]) > EPISODE_GAUSSIAN_RTOL * a["gaussians"]):
        raise AssertionError(f"small episode: at the end the card has {b['gaussians']} Gaussians "
                             f"and {b['area']:.3f} m^2 free, the CPU {a['gaussians']} and "
                             f"{a['area']:.3f} m^2")
    print(f"small episode ({cfg['steps']} steps of single_room at {cfg['res']}x{cfg['res']}): the "
          f"card's actions equal the CPU's through tick {arrived}, where the FSM ends its "
          f"navigation to the first target {first['px']}, reached at {first['closest_px']} px "
          f"({k} actions; {sum(x == y for x, y in zip(a['actions'], b['actions']))} of "
          f"{cfg['steps']} equal in all); at the end {b['gaussians']} / {a['gaussians']} "
          f"Gaussians (capacity {SMALL_EPISODE_CFG['max_capacity']}), {b['area']:.3f} / "
          f"{a['area']:.3f} m^2 free (card / CPU) on {card}")


def lpips_check(torch, np, card, rgb_a, rgb_b) -> float:
    """LPIPS(alex) on weights drawn from a seed (tests/test_lpips.py's
    recipe), on the card and on the CPU, on one pair of 256x256 frames:
    within LPIPS_REL. Returns the card's ms a pair (CUDA events)."""
    from activesplat_tpu_torch.eval import lpips as lp

    weights = lp.random_weights(np.random.default_rng(3))
    values = {dev: lp.lpips(rgb_a, rgb_b, weights=weights, device=dev) for dev in ("cpu", "cuda")}
    if abs(values["cuda"] - values["cpu"]) > LPIPS_REL * abs(values["cpu"]):
        raise AssertionError(f"LPIPS card {values['cuda']} against CPU {values['cpu']}")
    net = lp.network(weights, "cuda")
    a, b = (torch.as_tensor(x, device="cuda").clamp(0, 1) for x in (rgb_a, rgb_b))
    with torch.no_grad():
        ms = cuda_ms(lambda: net(a, b), 20)
    print(f"LPIPS(alex) on seeded weights, a {rgb_a.shape[0]}x{rgb_a.shape[1]} pair: card "
          f"{values['cuda']:.7f}, CPU {values['cpu']:.7f} (rel {LPIPS_REL}); {ms:.3f} ms a pair "
          f"(CUDA events, 20 calls) on {card}")
    return ms


def small_judges_check(torch, np, card, small_dir) -> None:
    """The judges on the card against the same on the CPU, over the small
    episode's outputs in `small_dir` (its CPU run): eval_map_quality
    (exact, k=EVAL_K; LPIPS on seeded weights through the env gate) within
    JUDGE_RTOL / JUDGE_ATOL, and fit_offline with the small episode's mapper
    config, the mapping picks made deterministic on both devices (the
    current frame every iteration, as small_episode_check does): the
    gradients of its first mapping event (two Adam steps) as FIT_GRAD_RTOL
    says, its metrics within FIT_RTOL and Gaussian count within
    FIT_GAUSSIAN_RTOL."""
    import os
    import tempfile

    from activesplat_tpu_torch.eval import lpips as lp
    from activesplat_tpu_torch.eval.replay import eval_map_quality
    from activesplat_tpu_torch.mapper import step
    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.runtime.offline_fit import fit_offline

    gdir = os.path.join(small_dir, "gaussians_data")
    params_path = os.path.join(gdir, "params.npz")
    rand, old_env = torch.rand, os.environ.get("ACTIVESPLAT_LPIPS_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp:
        weights_path = os.path.join(tmp, "lpips_alex_seeded.npz")
        np.savez(weights_path, **lp.random_weights(np.random.default_rng(3)))
        os.environ["ACTIVESPLAT_LPIPS_WEIGHTS"] = weights_path
        try:
            scores = {dev: eval_map_quality(params_path, gdir, frame_stride=2, k_per_tile=EVAL_K,
                                            chunk=128, device=dev) for dev in ("cpu", "cuda")}
        finally:
            if old_env is None:
                os.environ.pop("ACTIVESPLAT_LPIPS_WEIGHTS")
            else:
                os.environ["ACTIVESPLAT_LPIPS_WEIGHTS"] = old_env
    real_adam, grads = step.adam_update, {}

    def adam(params, g, *a, **k):  # the first event's gradients, on the host
        if len(grads[adam.dev]) < 2:
            grads[adam.dev].append([t.detach().cpu() for t in g.tensors()])
        return real_adam(params, g, *a, **k)

    try:
        torch.rand = lambda *a, **k: torch.full_like(rand(*a, **k), 1 - 2.0**-24)
        step.adam_update = adam
        fits = {}
        for dev in ("cpu", "cuda"):
            adam.dev, grads[dev] = dev, []
            fits[dev] = fit_offline(gdir, MapperConfig(**SMALL_EPISODE_CFG), device=dev)
    finally:
        torch.rand, step.adam_update = rand, real_adam
    flips, p99 = 0, 0.0
    for ga, gb in zip(grads["cpu"], grads["cuda"]):
        for x, y in zip(ga, gb):
            sig = x.abs() > 1e-6 * x.abs().max()
            flips += int((sig & (torch.sign(x) != torch.sign(y))).sum())
            if sig.any():
                p99 = max(p99, float(((x - y).abs() / x.abs())[sig].quantile(0.99)))
    if len(grads["cuda"]) != 2 or flips or p99 > FIT_GRAD_RTOL:
        raise AssertionError(f"small judges: fit_offline's first-event gradients, card against "
                             f"CPU: {flips} signs differ, 99th percentile relative error {p99:.2e}")
    a, b = scores["cpu"], scores["cuda"]
    if set(a) != set(b) or "lpips" not in a or any(
            abs(b[k] - a[k]) > JUDGE_ATOL + JUDGE_RTOL * abs(a[k]) for k in a):
        raise AssertionError(f"small judges: map quality card {b} against CPU {a}")
    fa, fb = fits["cpu"], fits["cuda"]
    keys = ("psnr", "ssim", "ms_ssim", "depth_l1", "depth_rmse")
    worst = max(abs(fb[k] - fa[k]) / abs(fa[k]) for k in keys)
    if (worst > FIT_RTOL or abs(fb["num_gaussians"] - fa["num_gaussians"])
            > FIT_GAUSSIAN_RTOL * fa["num_gaussians"]):
        raise AssertionError(f"small judges: fit_offline card {fb} against CPU {fa}")
    print(f"small judges (the small episode's {fa['num_frames']} frames): map quality card / "
          f"CPU {json.dumps(b)} / {json.dumps(a)} (LPIPS on seeded weights); fit_offline "
          f"{fb['num_gaussians']} / {fa['num_gaussians']} Gaussians, metrics within {worst:.2e} "
          f"relative (psnr {fb['psnr']:.6f} / {fa['psnr']:.6f}), first-event gradients: no sign "
          f"differs, 99th percentile relative error {p99:.2e} on {card}")


def habitat_env_yaml(path, res: int, turn: float) -> str:
    """tests/test_torch_habitat.py's small env yaml (activesplat_pointnav.yaml's
    agent at res x res), written by hand: the card's machine has no PyYAML."""
    sensor = (f"            width: {res}\n            height: {res}\n            hfov: 90\n"
              f"            position: [0, 1.25, 0]\n")
    Path(path).write_text(
        "habitat:\n  simulator:\n"
        f"    turn_angle: {turn}\n    tilt_angle: 15\n    forward_step_size: 0.065\n"
        "    agents:\n      main_agent:\n        height: 1.5\n        radius: 0.1\n"
        "        sim_sensors:\n          rgb_sensor:\n" + sensor
        + "          depth_sensor:\n" + sensor
        + "            min_depth: 0.0\n            max_depth: 10.0\n"
        "    habitat_sim_v0:\n      allow_sliding: false\n")
    return str(path)


def habitat_small_check(torch, np, card) -> None:
    """The Habitat adapter on its mock on the card against the same on the
    CPU: tests/test_torch_habitat_episode.py's parity run (HABITAT_SMALL),
    the mapping picks the current frame on both devices. Fatal unless every
    action is equal, the Gaussian counts are equal and the explored area is
    within EPISODE_AREA_RTOL."""
    import os
    import tempfile

    from activesplat_tpu_torch.configs import load_scene_config
    from activesplat_tpu_torch.io.actions import read_actions
    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.runtime.launch import build_episode_from_config, run_episode
    from activesplat_tpu_torch.runtime.mock_habitat import make_mock_sim

    c = HABITAT_SMALL
    rand = torch.rand
    runs = {}
    try:
        torch.rand = lambda *a, **k: torch.full_like(rand(*a, **k), 1 - 2.0**-24)
        for dev in ("cpu", "cuda"):
            with tempfile.TemporaryDirectory() as tmp:
                cfg = json.loads(json.dumps(load_scene_config("gibson")))
                cfg["env"]["config"] = habitat_env_yaml(os.path.join(tmp, "env.yaml"), c["res"],
                                                        c["turn"])
                cfg["dataset"].update(step_num=c["steps"], scene_id=c["scene"], far=10)
                cfg["painter"]["grid_map"]["pixel_max"] = 56
                np.random.seed(0)  # the Voronoi sampling jitter's global stream
                ep = build_episode_from_config(cfg, tmp, sim_factory=make_mock_sim)
                node, planner = run_episode(
                    ep["dataset"], tmp, mapper_cfg=MapperConfig(**SMALL_EPISODE_CFG),
                    pixel_max=ep["pixel_max"], max_ticks=300, pano_scale=0.4,
                    single_floor_expansion=ep["single_floor_expansion"],
                    agent_foot_adjust=ep["agent_foot_adjust"], device=dev)
                runs[dev] = {"actions": read_actions(os.path.join(tmp, "actions.txt")),
                             "gaussians": node.mapper.num_gaussians(),
                             "area": np.count_nonzero(planner.free_map)
                             * planner.topdown_cfg.meter_per_pixel ** 2}
    finally:
        torch.rand = rand
    a, b = runs["cpu"], runs["cuda"]
    if (a["actions"] != b["actions"] or a["gaussians"] != b["gaussians"]
            or abs(b["area"] - a["area"]) > EPISODE_AREA_RTOL * a["area"]):
        raise AssertionError(f"small habitat episode: card {b}, CPU {a}")
    print(f"small habitat episode ({c['steps']} steps of the gibson config on the mock, scene "
          f"{c['scene']}, {c['res']}x{c['res']}): the card's {len(b['actions'])} actions equal the "
          f"CPU's, {b['gaussians']} / {a['gaussians']} Gaussians, {b['area']:.3f} / "
          f"{a['area']:.3f} m^2 free (card / CPU) on {card}")


def native_raycast_check(np, card) -> None:
    """One HIGH_RES x HIGH_RES frame of the mock's world (BoxWorld.render),
    the native raycaster (built from csrc/raycast.cpp) against the numpy one
    on the host: NATIVE_REPS calls each, the frames within NATIVE_ATOL."""
    import os

    from activesplat_tpu_torch.runtime import native_raycast
    from activesplat_tpu_torch.runtime.synthetic import BoxWorld
    from activesplat_tpu_torch.utils.transforms import rot_axis

    world = BoxWorld.two_room(seed=0)
    f = HIGH_RES / 2
    intr = np.array([[f, 0, f - 1], [0, f, f - 1], [0, 0, 1]])
    c2w = query_pose(np, (5.0, 1.25, 1.5))
    c2w = rot_axis(c2w, "y", np.deg2rad(35.0))
    t0 = time.perf_counter()
    native_raycast.get_lib()
    build_s = time.perf_counter() - t0
    frames, ms = {}, {}
    old = os.environ.get("ACTIVESPLAT_NATIVE")
    try:
        for label, flag in (("native", "1"), ("numpy", "0")):
            os.environ["ACTIVESPLAT_NATIVE"] = flag
            frames[label] = world.render(c2w, intr, HIGH_RES, HIGH_RES)
            t0 = time.perf_counter()
            for _ in range(NATIVE_REPS):
                world.render(c2w, intr, HIGH_RES, HIGH_RES)
            ms[label] = (time.perf_counter() - t0) / NATIVE_REPS * 1e3
    finally:
        if old is None:
            os.environ.pop("ACTIVESPLAT_NATIVE", None)
        else:
            os.environ["ACTIVESPLAT_NATIVE"] = old
    err = max(float(np.abs(a - b).max()) for a, b in zip(frames["native"], frames["numpy"]))
    if err > NATIVE_ATOL:
        raise AssertionError(f"native raycaster: {err:.3e} from the numpy one")
    print(f"native raycaster: {HIGH_RES}x{HIGH_RES} frame {ms['native']:.3f} ms native, "
          f"{ms['numpy']:.3f} ms numpy ({NATIVE_REPS} calls each, host clock), max difference "
          f"{err:.3e}; library load (built if missing) {build_s:.2f} s, on the host of {card}")


def rel_err(torch, got, want) -> float:
    """The largest difference over the largest magnitude of `want`."""
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)


def driver_intrinsics(np, res: int):
    """The episode's sensor (RGBDSensor.from_fov): 90 degrees hfov, square
    pixels, cx = W/2 - 1."""
    from activesplat_tpu_torch.utils.transforms import compute_intrinsics

    fx, fy, cx, cy = compute_intrinsics(res, res, math.radians(90.0))
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def driver_frames(np, world, intr, frames: int, res=None):
    """A walk's frames at res x res (default RES), rendered up front: from
    the hermetic episode's start (make_synthetic_dataset's search for a free spot near
    the room centre) three left turns of TURN_DEG, then one forward step of
    FORWARD_STEP (skipped where blocked), over and over; each frame the
    agent's camera (SyntheticDataset.camera_c2w) at CAMERA_HEIGHT."""
    from activesplat_tpu_torch.utils.transforms import rot_axis

    res = res or RES
    sx, _, sz = world.size
    pos = next(c for c in (np.array([sx / 2 + dx, 0.0, sz / 4])
                           for dx in np.linspace(0, min(sx, sz) / 2 - 0.5, 8))
               if world.is_free(c[[0, 2]], 0.2))
    yaw, out = 0.0, []
    for i in range(frames):
        c2w = np.eye(4)
        c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
        c2w[:3, 3] = pos + [0.0, CAMERA_HEIGHT, 0.0]
        c2w = rot_axis(c2w, "y", np.deg2rad(-yaw))
        rgb, depth = world.render(c2w, intr, res, res, depth_max=10.0, depth_min=0.0)
        out.append({"frame_id": i, "rgb": rgb, "depth": depth, "c2w": c2w})
        if i % 4 == 3:
            ahead = pos + FORWARD_STEP * np.array([-np.sin(np.deg2rad(yaw)), 0.0,
                                                   -np.cos(np.deg2rad(yaw))])
            if world.is_free(ahead[[0, 2]], 0.1):
                pos = ahead
        else:
            yaw = (yaw + TURN_DEG) % 360
    return out


def read_launches(rc, what: str, expect=None) -> dict:
    """Read and reset the kernel launch counters; with `expect` ({kernel:
    launches}, every kernel it does not name 0) fail unless they match and
    the row gathers' backward ran once for each blend backward."""
    counts = {fn.__name__: fn.launches for fn in rc.KERNELS}
    gathers = rc.gather_rows_bwd.launches
    rc.reset_launch_counts()
    if expect is not None:
        want = {name: expect.get(name, 0) for name in counts}
        backwards = want["blend_tiles_bwd"] + want["blend_csr_bwd"]
        if counts != want or gathers != backwards:
            raise AssertionError(f"{what}: kernel launches {counts} and {gathers} gather "
                                 f"backwards, not {want} and {backwards}")
    return counts


def bound(rates, nbytes, walked, live, live_f32, extra_f32=0, extra_sfu=0):
    """A blend's least time a call in ms on these inputs and what sets it:
    its `nbytes` at HBM_BYTES_PER_S, or its float32 operations (WALKED_F32
    a walked pair, `live_f32` more a live one) at F32_FLOPS and its
    special-function results (LIVE_SFU a live pair) at rates["sfu"],
    whichever takes longer."""
    f32_ops = walked * WALKED_F32 + live * live_f32 + extra_f32
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(f32_ops / F32_FLOPS, (live * LIVE_SFU + extra_sfu) / rates["sfu"]) * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by


def measure(torch, name, src, repl, run, plain, kernels, b_ms_by, err, plain_reps=5, **extra):
    """One kernel's entry: the device ms of its passes `kernels` in a call
    of the wrapper `run` ("ms" their sum), the wrapper's and its twin
    `plain`'s ms a call, its bound `b_ms_by` (ms, what sets it) and the
    largest error `err` against the twin."""
    pass_ms = kernel_device_ms(torch, run, kernels, 20)
    return {"name": name, "route": "cuda", "source": src, "replaces": repl, "max_abs_err": err,
            "ms": sum(pass_ms.values()), "wrapper_ms": cuda_ms(run, 100),
            "plain_ms": cuda_ms(plain, plain_reps), "bound_ms": b_ms_by[0],
            "bound_by": b_ms_by[1], "library_ms": None, "pass_ms": pass_ms, **extra}


def tile_entries(torch, rc, rows, u0, v0, where, rejected, rates) -> list:
    """B1 and B2 on one set of tile rows: held against their twins
    (kernel_checks, counting planted faults in rejected["B1"] and
    rejected["B2"]), then timed and bounded. Bytes: the walked segments'
    rows, the origins, the pixels' outputs and the stash (B1); the same
    with the pixels' cotangents and every gradient row written (B2)."""
    t, k, _ = rows.shape
    errs, (entry, g_acc, g_lt) = kernel_checks(torch, rc, rows, u0, v0,
                                               f"{where} tile rows T={t} K={k}", rejected["B2"],
                                               rejected["B1"])
    walked, live, live_wr = pair_counts(torch, rc, rows, u0, v0, entry)
    print(f"{where} tile rows: {walked} (row, pixel) pairs walked, {live} of them live "
          f"({live / walked:.4f}), {live_wr} of {walked // 32} warp-rows (B2's 8x4-pixel warps) "
          f"hold a live pair ({live_wr / (walked // 32):.4f})")
    walk_bytes = walked // (rc.SEG * rc.PX) * rc.SEG * rc.N_ATTR * 4 + 2 * t * 4
    px_bytes = t * rc.PX * 4
    fwd = (rows, u0, v0, N_CHANNELS)
    bwd = (rows, u0, v0, entry, g_acc, g_lt, N_CHANNELS)
    pairs = {"walked": walked, "live": live, "live_warp_rows": live_wr, "warp_rows": walked // 32}
    return [
        measure(torch, "blend_tiles_fwd", "activesplat_tpu_torch/csrc/blend_fwd.cu", FWD_REPLACES,
                lambda: rc.blend_tiles_fwd(*fwd, with_entry=True),
                lambda: rc.blend_tiles_fwd_plain(*fwd, with_entry=True), B1_PASSES,
                bound(rates, walk_bytes + px_bytes * (N_CHANNELS + 1 + k // rc.SEG), walked, live,
                      live_f32_fwd(N_CHANNELS)),
                errs["fwd"], stream=where, tiles=t, k=k, pairs=pairs,
                segments=dict(zip(("computed", "walked"), errs["segments"]),
                              all=t * (k // rc.SEG))),
        measure(torch, "blend_tiles_bwd", "activesplat_tpu_torch/csrc/blend_bwd.cu", BWD_REPLACES,
                lambda: rc.blend_tiles_bwd(*bwd), lambda: rc.blend_tiles_bwd_plain(*bwd),
                B2_PASSES,
                bound(rates, walk_bytes + px_bytes * (k // rc.SEG + N_CHANNELS + 1)
                      + t * k * rc.N_ATTR * 4, walked, live, live_f32_bwd(N_CHANNELS)),
                errs["bwd"], stream=where, tiles=t, k=k, pairs=pairs)]


def csr_entries(torch, rc, stream, n_tiles, where, rejected, rates, c=N_CHANNELS,
                with_bwd=True) -> list:
    """B3, and with `with_bwd` B4, on one CSR stream: held against their
    twins (csr_kernel_checks, counting planted faults in rejected["B3/B5"]
    and rejected["B4"]), then timed and bounded. Bytes: the walked
    segments' rows, the per-tile segment ranges and the pixels' outputs or
    cotangents; with `with_bwd` (a training stream) also the stash, written
    by B3 and read by B4, and B4's gradient rows, every one of them written.
    Without it the stream is a forward-only render's, with no stash."""
    seg_tile = stream[1]
    n_seg = seg_tile.shape[0]
    errs, (entry, g_acc, g_lt) = csr_kernel_checks(
        torch, rc, stream, n_tiles, f"{where} CSR stream, {n_seg} segments", rejected["B3/B5"], c=c,
        with_bwd=with_bwd, bwd_rejected=rejected["B4"])
    seg, walked, live = csr_pair_counts(torch, rc, stream, entry, n_tiles)
    print(f"{where} CSR stream: {seg} of {n_seg} segments walked, {errs['segments'][0]} computed "
          f"by pass 1, {walked} (row, pixel) pairs walked, {live} of them live "
          f"({live / walked:.4f})")
    seg_bytes = rc.CSEG * rc.N_ATTR * 4
    stash_bytes = n_seg * rc.PX * 4 if with_bwd else 0
    fwd = (*stream, n_tiles, c)
    out = [measure(torch, "blend_csr_fwd", "activesplat_tpu_torch/csrc/blend_csr_fwd.cu",
                   CSR_FWD_REPLACES, lambda: rc.blend_csr_fwd(*fwd, with_entry=with_bwd),
                   lambda: rc.blend_csr_fwd_plain(*fwd, with_entry=with_bwd), CSR_PASSES,
                   bound(rates, seg * seg_bytes + 2 * n_tiles * 4 + stash_bytes
                         + n_tiles * rc.PX * 4 * (c + 1), walked, live, live_f32_fwd(c)),
                   errs["fwd"], plain_reps=2, stream=where,
                   segments={"walked": seg, "computed": errs["segments"][0], "all": n_seg})]
    if with_bwd:
        visited = int(torch.unique(seg_tile[seg_tile < n_tiles]).numel())
        bwd = (*stream, entry, g_acc, g_lt, n_tiles, c)
        out.append(measure(torch, "blend_csr_bwd", "activesplat_tpu_torch/csrc/blend_csr_bwd.cu",
                           CSR_BWD_REPLACES, lambda: rc.blend_csr_bwd(*bwd),
                           lambda: rc.blend_csr_bwd_plain(*bwd), B4_PASSES,
                           bound(rates, seg * seg_bytes + 2 * n_tiles * 4 + stash_bytes
                                 + visited * rc.PX * 4 * (c + 1) + n_seg * seg_bytes, walked,
                                 live, live_f32_bwd(c)),
                           errs["bwd"], stream=where, pairs={"walked": walked, "live": live}))
    return out


def dual_entry(torch, rc, stream, n_tiles, where, rejected, rates) -> dict:
    """B5 on one top-down CSR stream: held against its twin
    (dual_kernel_checks, counting planted faults in rejected["B3/B5"]), then
    timed and bounded. Bytes: the walked segments' rows, the per-tile
    segment ranges and the pixels' outputs (C colours and two
    log-transmittances); operations: B3's at C=3, plus the band's log1p and
    add per band-live pair."""
    n_seg = stream[1].shape[0]
    err, entry, _, (computed, _) = dual_kernel_checks(
        torch, rc, stream, n_tiles, f"{where} top-down CSR stream, {n_seg} segments",
        rejected["B3/B5"], require_exit_fault=False)
    seg, walked, live, band = dual_pair_counts(torch, rc, stream, entry, n_tiles)
    print(f"{where} top-down CSR stream: {seg} of {n_seg} segments walked, {computed} computed by "
          f"pass 1, {walked} (row, pixel) pairs walked, {live} of them live "
          f"({live / walked:.4f}), {band} of those in the band")
    nbytes = (seg * rc.CSEG * rc.N_ATTR * 4 + 2 * n_tiles * 4
              + n_tiles * rc.PX * 4 * (DUAL_CHANNELS + 2))
    args = (*stream, n_tiles, DUAL_CHANNELS)
    return measure(torch, "blend_csr_dual_fwd", "activesplat_tpu_torch/csrc/blend_csr_dual.cu",
                   DUAL_REPLACES, lambda: rc.blend_csr_dual_fwd(*args),
                   lambda: rc.blend_csr_dual_fwd_plain(*args), CSR_PASSES,
                   bound(rates, nbytes, walked, live, live_f32_fwd(DUAL_CHANNELS), band, band),
                   err, plain_reps=2, stream=where,
                   segments={"walked": seg, "computed": computed, "all": n_seg})


def bin_entry(torch, rc, rt, prefix, k, where, rates, card) -> dict:
    """B6 on one render's bin, `prefix` its visible prefix as bin_gaussians
    takes it (mean2d, radius, valid, width, height): its passes and its
    route held at slot offsets 0 and k (bin_checks; every planted fault of
    the output must show), then timed at offset 0 and bounded pass by pass
    (bin_bound)."""
    rejected, split_rejected = dict.fromkeys(BIN_FAULTS, 0), dict.fromkeys(BIN_SPLIT_FAULTS, 0)
    [(_, count_args, args, lists), _] = bin_checks(
        torch, rc, rt, prefix, k, (0, k), f"{where} bin, visible prefix of {prefix[0].shape[0]} "
        f"splats", rejected, split_rejected)
    if not all(rejected.values()):
        raise AssertionError(f"{where}: a planted bin fault never showed: {rejected}")
    print(f"{where} bin: planted faults of B6's two passes rejected: {split_rejected}")
    counts = rc.bin_count_cuda(*count_args)[1]
    bb = bin_bound(torch, rc, count_args, args, counts, lists.indices, rates["int"])
    run, plain = b6_calls(torch, rc, count_args, args)
    entry = measure(torch, "bin_slots", "activesplat_tpu_torch/csrc/bin_slots.cu", BIN_REPLACES,
                    run, plain, B6_PASSES, b6_bound_ms(bb), 0.0, stream=where, k=k,
                    pass_bound_ms={p: bb[p][0] for p in ("count", "slot")},
                    bound_slot_search_ms=bb["old"][0])
    print_bin_bound(bb, f"{where} bin (k={k}, offset 0)",
                    {"count": entry["pass_ms"][B6_PASSES[0]],
                     "slot": entry["pass_ms"][B6_PASSES[1]]}, card)
    return entry


def render_inputs(torch, rc, rt, buf, cam, k):
    """The kernels' inputs for one camera on one map: the tile rows of a
    k-capped render (B1, B2), the CSR stream of an exact render and its
    tile count (B3, B4), and the k-capped render's bin, its visible prefix
    as bin_gaussians takes it (B6), which must fit the kernel route's gate."""
    from activesplat_tpu_torch.ops.render import render

    seen = []
    real = rt.bin_gaussians
    rt.bin_gaussians = lambda *a, **kw: seen.append(a) or real(*a, **kw)
    try:
        with torch.no_grad():
            render(buf, cam, k_per_tile=k)
    finally:
        rt.bin_gaussians = real
    prefix = seen[0][:5]
    if -(-prefix[0].shape[0] // rc.BIN_BLOCK) > rc.BIN_MAX_BLOCKS:
        raise AssertionError(f"the render's visible prefix of {prefix[0].shape[0]} splats passes "
                             f"the bin kernel route's gate of {rc.BIN_MAX_BLOCKS} blocks")
    return main_path_rows(torch, buf, cam, k), main_path_csr(torch, buf, cam), prefix


def exact_render_check(torch, rc, buf, cam) -> None:
    """The forward-only exact render: one launch of B3, without the stash
    (its output carries no autograd graph although the parameters ask for
    gradients, so BlendCSR saves nothing and B3 runs without the stash),
    giving the image of the exact_training="on" render's forward."""
    from activesplat_tpu_torch.ops.render import render

    grad_buf = buf.replace(params=buf.params.map(lambda x: x.detach().requires_grad_(True)))
    rc.reset_launch_counts()
    exact_img = render(grad_buf, cam, k_per_tile=K_PER_TILE, exact=True)
    read_launches(rc, "render(exact=True)", {"blend_csr_fwd": 1})
    if exact_img.rgb.requires_grad:
        raise AssertionError("render(exact=True) built an autograd graph")
    on_img = render(grad_buf, cam, k_per_tile=K_PER_TILE, grad_exact=True)
    rc.reset_launch_counts()
    gap = max(float((getattr(exact_img, f) - getattr(on_img, f).detach()).abs().max())
              for f in ("rgb", "depth", "alpha"))
    if gap > 1e-6 or int(exact_img.dropped) != 0:
        raise AssertionError(f"render(exact=True) differs from the 'on' forward by {gap:.3e}")
    print(f"render(exact=True): one B3 launch without the stash; rgb, depth and alpha "
          f"within {gap:.3e} of the exact_training='on' render's forward")


def high_res_map(torch, np):
    """Phase 5's map: SplaTAMMapper with the HIGH_CONFIG scene config's
    mapper on the card, fed MAP_FRAMES frames of
    BoxWorld.single_room(HIGH_WORLD_SEED) at HIGH_RES x HIGH_RES along
    driver_frames' walk. Returns (the mapper, the camera of its last frame,
    the room's top-down config at the scene config's pixel_max)."""
    from activesplat_tpu_torch.configs import load_scene_config, mapper_config_from_scene
    from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
    from activesplat_tpu_torch.queries.topdown import topdown_config_from_bbox
    from activesplat_tpu_torch.runtime.synthetic import BoxWorld

    scene_cfg = load_scene_config(HIGH_CONFIG)
    world = BoxWorld.single_room(seed=HIGH_WORLD_SEED)
    intr = driver_intrinsics(np, HIGH_RES)
    frames = driver_frames(np, world, intr, MAP_FRAMES, HIGH_RES)
    mapper = SplaTAMMapper(mapper_config_from_scene(scene_cfg), HIGH_RES, HIGH_RES, intr,
                           DRIVER_STEP_NUM, device="cuda")
    t0 = time.perf_counter()
    for batch in frames:
        mapper.run(batch)
    torch.cuda.synchronize()
    sx, sy, sz = world.size
    td_cfg = topdown_config_from_bbox(np.array([[0.0, sx], [0.0, sy], [0.0, sz]]), agent_foot=0.0,
                                      agent_head=1.5,
                                      pixel_max=scene_cfg["painter"]["grid_map"]["pixel_max"])
    print(f"{HIGH_CONFIG} map: {mapper.num_gaussians()} Gaussians from {MAP_FRAMES} frames at "
          f"{HIGH_RES}x{HIGH_RES} in {time.perf_counter() - t0:.1f} s (shape history "
          f"{mapper.shape_history})")
    return mapper, mapper._camera(np.linalg.inv(frames[-1]["c2w"])), td_cfg


def mesh_checks(torch, np, rc, scene, qbuf) -> None:
    """Phase 4: the multi-device path on a virtual mesh of the card against
    the unsharded path (see the module docstring), on phase 3's map `scene`
    and query map `qbuf`."""
    from activesplat_tpu_torch.mapper import step
    from activesplat_tpu_torch.mapper.config import MapperConfig
    from activesplat_tpu_torch.mapper.keyframes import KeyframeStore
    from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper
    from activesplat_tpu_torch.ops.render import render
    from activesplat_tpu_torch.parallel import sharded
    from activesplat_tpu_torch.queries.panorama import global_invisibility, local_invisibility
    from activesplat_tpu_torch.runtime.synthetic import BoxWorld
    from activesplat_tpu_torch.utils.transforms import rot_axis

    n_cards = torch.cuda.device_count()
    mesh = sharded.make_render_mesh([torch.device("cuda", 0)] * MESH_SHARDS)
    buf, cam, cfg = scene.buf, scene.cam, scene.cfg
    rgb0, depth0 = scene.frame(scene.c2w)
    print(f"mesh: torch.cuda.device_count() = {n_cards}; a virtual mesh of {mesh.px} shards on "
          f"{mesh.devices[0]} ({RES // MESH_SHARDS} rows each at {RES}x{RES})")
    b1, b2, b3, b4 = (fn.__name__ for fn in rc.KERNELS[:4])

    # the sharded render against the unsharded one; `dropped` against the
    # sum of the shards' own renders
    shard_dropped = []
    real_tiled = sharded.rasterize_tiled
    sharded.rasterize_tiled = lambda *a, **kw: (lambda out: shard_dropped.append(int(out[2]))
                                                or out)(real_tiled(*a, **kw))
    try:
        rc.reset_launch_counts()
        with torch.no_grad():
            got = sharded.render_sharded_tiled(buf, cam, mesh, k_per_tile=K_PER_TILE)
        read_launches(rc, "mesh render", {b1: MESH_SHARDS})
    finally:
        sharded.rasterize_tiled = real_tiled
    with torch.no_grad():
        ref = render(buf, cam, k_per_tile=K_PER_TILE)
    read_launches(rc, "mesh reference render", {b1: 1})
    errs = {f: rel_err(torch, g, getattr(ref, f)) for f, g in zip(("rgb", "depth", "alpha"), got)}
    if (max(errs.values()) > MESH_IMG_REL or len(shard_dropped) != MESH_SHARDS
            or int(got[4]) != sum(shard_dropped) or not torch.equal(got[3], ref.radii)):
        raise AssertionError(f"mesh render: errors {errs} of each field's largest, dropped "
                             f"{int(got[4])} against the shards' {shard_dropped}")
    print(f"mesh render (k={K_PER_TILE}): rgb, depth, alpha within {errs} of each field's largest "
          f"value of the unsharded render; dropped {int(got[4])} = the shards' {shard_dropped} "
          f"(unsharded {int(ref.dropped)}); B1 launched {MESH_SHARDS} times")
    if n_cards > 1:
        real = sharded.mesh_for_height(RES)
        if real is not None:
            with torch.no_grad():
                got_r = sharded.render_sharded_tiled(buf, cam, real, k_per_tile=K_PER_TILE)
            errs_r = {f: rel_err(torch, g.to(ref.rgb.device), getattr(ref, f))
                      for f, g in zip(("rgb", "depth", "alpha"), got_r)}
            rc.reset_launch_counts()
            if max(errs_r.values()) > MESH_IMG_REL:
                raise AssertionError(f"mesh render over {real.devices}: errors {errs_r}")
            print(f"mesh render over the {real.px} real devices {real.devices}: within {errs_r}")
    else:
        print("mesh render over several real devices: not run (this machine has one card)")

    # the loss and its gradients against mapping_loss
    for mode, k, ref_mode, expect in (
            ("off", K_PER_TILE, "off", {b1: MESH_SHARDS, b2: MESH_SHARDS}),
            ("on", K_PER_TILE, "on", {b3: MESH_SHARDS, b4: MESH_SHARDS}),
            ("hybrid", HYBRID_K, "on", {b3: MESH_SHARDS, b4: MESH_SHARDS})):
        cfg_m = dataclasses.replace(cfg, k_per_tile=k, exact_training=mode)
        rc.reset_launch_counts()
        loss_m, aux_m, g_m = step.loss_and_grads(buf, cam, rgb0, depth0, cfg_m, mesh=mesh)
        launches = read_launches(rc, f"mesh loss {mode}", expect)
        loss_s, aux_s, g_s = step.loss_and_grads(
            buf, cam, rgb0, depth0, dataclasses.replace(cfg_m, exact_training=ref_mode))
        read_launches(rc, f"unsharded loss {ref_mode}", dict.fromkeys(expect, 1))
        g_err = max(rel_err(torch, a, b) for a, b in zip(g_m.tensors(), g_s.tensors()))
        l_err = abs(float(loss_m) - float(loss_s)) / abs(float(loss_s))
        if l_err > MESH_LOSS_RTOL or g_err > MESH_GRAD_REL or (
                mode != "off" and int(aux_m.dropped) != 0):
            raise AssertionError(f"mesh loss {mode} (k={k}): loss {float(loss_m)} against "
                                 f"{float(loss_s)}, gradients {g_err:.3e} of scale, dropped "
                                 f"{int(aux_m.dropped)}")
        print(f"mesh loss exact_training={mode!r} (k={k}) against the unsharded {ref_mode!r}: "
              f"loss {float(loss_m):.7f} ({l_err:.3e} relative), gradients within {g_err:.3e} "
              f"of each field's largest, dropped {int(aux_m.dropped)} (unsharded "
              f"{int(aux_s.dropped)}); launches {launches}")
    # unsharded, "hybrid" finds harmful tiles at HYBRID_K: all four blends run
    step.loss_and_grads(buf, cam, rgb0, depth0,
                        dataclasses.replace(cfg, k_per_tile=HYBRID_K, exact_training="hybrid"))
    read_launches(rc, f"unsharded loss hybrid (k={HYBRID_K})", dict.fromkeys((b1, b2, b3, b4), 1))

    # one mapping event of MESH_EVENT_ITERS iterations on the mesh against
    # the unsharded one: the same map, keyframes and draws
    store = KeyframeStore.empty(16, RES, RES)
    views = []
    for ev in range(3):
        c2w = rot_axis(scene.c2w, "y", np.deg2rad(4.0 * ev))
        c2w[:3, 3] += [0.05 * ev, 0.0, 0.0]
        rgb, depth = scene.frame(c2w)
        w2c = torch.from_numpy(np.linalg.inv(c2w).astype(np.float32)).cuda()
        views.append((rgb, depth, w2c))
    for ev, (rgb, depth, w2c) in enumerate(views[:2]):
        store.committed(rgb, depth, w2c, ev)
    real_lg = step.loss_and_grads
    first_grads, events = {}, {}

    def recording(*a, **kw):  # the first iteration's gradients of each event
        out = real_lg(*a, **kw)
        first_grads.setdefault(len(events), out[2])
        return out

    # both events write the same scratch frame into the same store and draw
    # from a generator seeded alike, so they pick the same keyframes
    for name, m in (("mesh", mesh), ("single", None)):
        step.loss_and_grads = recording
        try:
            rc.reset_launch_counts()
            gen = torch.Generator(device="cuda").manual_seed(7)
            out = step.mapping_phase(buf, store, *views[2], 2, cam, gen, cfg, MESH_EVENT_ITERS,
                                     mesh=m)
            torch.cuda.synchronize()
        finally:
            step.loss_and_grads = real_lg
        events[name] = out
        per = MESH_SHARDS if m else 1
        read_launches(rc, f"{name} mapping_phase",
                      {b1: MESH_EVENT_ITERS * per, b2: MESH_EVENT_ITERS * per})
    g_err = max(rel_err(torch, a, b) for a, b in zip(first_grads[0].tensors(),
                                                      first_grads[1].tensors()))
    (_, _, mm), (_, _, sm) = events["mesh"], events["single"]
    names = ("loss", "psnr", "depth_l1", "rgb_l1", "ssim")
    first = max(abs(float(mm[k][0]) - float(sm[k][0])) / abs(float(sm[k][0])) for k in names)
    worst = max(float(((mm[k] - sm[k]).abs() / sm[k].abs()).max()) for k in names)
    if g_err > MESH_GRAD_REL or first > MESH_LOSS_RTOL or worst > MESH_METRIC_RTOL:
        raise AssertionError(f"mesh mapping_phase: first iteration's gradients {g_err:.3e} of "
                             f"scale, its metrics {first:.3e}, the event's {worst:.3e}")
    print(f"mesh mapping_phase ({MESH_EVENT_ITERS} iterations, window {int(mm['num_window'])}): "
          f"the first iteration's gradients within {g_err:.3e} of each field's largest and its "
          f"metrics within {first:.3e} relative of the unsharded event's; every iteration's "
          f"metrics within {worst:.3e} (losses {float(mm['loss'][0]):.5f} -> "
          f"{float(mm['loss'][-1]):.5f}, unsharded {float(sm['loss'][0]):.5f} -> "
          f"{float(sm['loss'][-1]):.5f})")
    del events, first_grads, views, store

    # the driver (MapperConfig()) over MESH_FRAMES frames on the mesh and unsharded
    intr = driver_intrinsics(np, RES)
    frames = driver_frames(np, BoxWorld.two_room(seed=0), intr, MESH_FRAMES)
    drivers = {}
    for name, m in (("mesh", mesh), ("single", None)):
        mapper = SplaTAMMapper(MapperConfig(), RES, RES, intr, DRIVER_STEP_NUM, device="cuda",
                               mesh=m)
        rc.reset_launch_counts()
        for batch in frames:
            mapper.run(batch)
        counts = read_launches(rc, f"{name} driver")
        iters = mapper.mapping_iter_time_count
        per = MESH_SHARDS if m else 1
        if not (counts[b2] == per * iters > 0 and counts[b1] >= per * iters and counts[b3] > 0):
            raise AssertionError(f"mesh driver ({name}): launches {counts} for {iters} mapping "
                                 f"iterations")
        drivers[name] = (mapper, counts)
    (a, a_counts), (b, _) = drivers["mesh"], drivers["single"]
    worst = max(abs(a.last_metrics[k] - v) / (abs(v) + 1e-12) for k, v in b.last_metrics.items())
    if (a.num_gaussians() != b.num_gaussians() or worst > MESH_METRIC_RTOL
            or a._densify_mesh is None or a.mesh != mesh):
        raise AssertionError(f"mesh driver: {a.num_gaussians()} Gaussians against "
                             f"{b.num_gaussians()}, metrics {a.last_metrics} against "
                             f"{b.last_metrics}")
    print(f"mesh driver ({MESH_FRAMES} frames of two_room at {RES}x{RES}, MapperConfig(), "
          f"{a.mapping_iter_time_count} mapping iterations): {a.num_gaussians()} Gaussians on "
          f"both; last metrics within {worst:.3e} relative ({a.last_metrics}); launches "
          f"{a_counts}")
    del drivers, a, b, mapper, frames

    # the panorama queries on the query map, views sharded
    view = query_pose(np, QUERY_VIEW)
    nodes = np.array(QUERY_NODES)
    rc.reset_launch_counts()
    scores = global_invisibility(qbuf, view, nodes, scale=0.5, mesh=mesh)
    read_launches(rc, "mesh global_invisibility", {b3: 2 * 3})
    single = global_invisibility(qbuf, view, nodes, scale=0.5)
    read_launches(rc, "mesh reference global_invisibility", {b3: 2 * 3})
    loc = local_invisibility(qbuf, view, mesh=mesh)
    read_launches(rc, "mesh local_invisibility", {b3: 3})
    loc_s = local_invisibility(qbuf, view)
    read_launches(rc, "mesh reference local_invisibility", {b3: 3})
    if scores != single or loc[0] != loc_s[0] or not np.array_equal(loc[2], loc_s[2]) or (
            (loc[1] is None) != (loc_s[1] is None)) or (
            loc[1] is not None and not np.array_equal(loc[1], loc_s[1])):
        raise AssertionError(f"mesh panoramas differ from the unsharded: {scores} against "
                             f"{single}, local sums {loc[0]} and {loc_s[0]}")
    print(f"mesh panoramas ({QUERY_GAUSSIANS} Gaussians; 6 views over {MESH_SHARDS} shards, then "
          f"3): global_invisibility {scores} and local_invisibility (sum {loc[0]:.3f}) equal to "
          f"the unsharded queries bitwise")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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
    occupancy = {"B1": rc.tile_fwd_occupancy(N_CHANNELS), "B2": rc.tile_bwd_occupancy(N_CHANNELS),
                 "B4": rc.csr_bwd_occupancy(N_CHANNELS)}
    for kernel, passes in occupancy.items():
        for name, occ in passes.items():
            print(f"{kernel} pass {name} (C={N_CHANNELS}): {occ['registers']} registers a thread, "
                  f"{occ['static_smem']} B static and {occ['dynamic_smem']} B dynamic shared "
                  f"memory a block, {occ['local_bytes']} B local, {occ['blocks_per_sm']} resident "
                  f"blocks of 256 threads a SM")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"sfu": SFU_PER_CLOCK_PER_SM * n_sm * max_sm_mhz * 1e6,
             "int": INT32_PER_CLOCK_PER_SM * n_sm * max_sm_mhz * 1e6}

    # ---- phase 2: kernels against their twins -------------------------- #
    # the planted faults each pass's checks reject, counted over phases 2-5
    rejected = {"B1": dict.fromkeys(TILE_FWD_FAULTS, 0), "B2": dict.fromkeys(TILE_SPLIT_FAULTS, 0),
                "B3/B5": dict.fromkeys(SPLIT_FAULTS, 0), "B4": dict.fromkeys(B4_SPLIT_FAULTS, 0)}
    rows, u0, v0 = random_tiles(torch, seed=0)
    kernel_checks(torch, rc, rows, u0, v0, "random tiles T=256 K=256", rejected["B2"],
                  rejected["B1"])
    rows, u0, v0 = random_tiles(torch, seed=1, k=192)  # K not a SEG multiple...
    rows = torch.nn.functional.pad(rows, (0, 0, 0, 64))  # ...padded to 256
    rows[:, 192:, 0:2] = -1e9
    rows[:, 192:, 2:5] = 1.0
    kernel_checks(torch, rc, rows.contiguous(), u0, v0, "padded K=192->256", rejected["B2"],
                  rejected["B1"])
    # the driver's k=1,024: the fold spans 16 segments
    rows, u0, v0 = random_tiles(torch, seed=2, k=1024)
    kernel_checks(torch, rc, rows, u0, v0, "random tiles T=256 K=1024", rejected["B2"],
                  rejected["B1"])
    del rows, u0, v0
    if not all(rejected["B1"].values()):
        raise AssertionError(f"a planted fault of B1's two passes never showed on the random "
                             f"tiles: {rejected['B1']}")
    if not all(rejected["B2"].values()):
        raise AssertionError(f"a planted fault of B2's two passes never showed on the random "
                             f"tiles: {rejected['B2']}")
    csr_kernel_checks(torch, rc, random_csr_stream(torch, seed=0), 256,
                      "random CSR stream, 256 tiles", rejected["B3/B5"],
                      bwd_rejected=rejected["B4"])
    if not all(rejected["B4"].values()):
        raise AssertionError(f"a planted fault of B4's two passes never showed on the random "
                             f"stream: {rejected['B4']}")
    dual_kernel_checks(torch, rc, random_dual_stream(torch, rc, seed=0), 256,
                       "random CSR stream with band bits, 256 tiles", rejected["B3/B5"])
    if not all(rejected["B3/B5"].values()):
        raise AssertionError(f"a planted fault of the two passes never showed on the random "
                             f"streams: {rejected['B3/B5']}")
    from activesplat_tpu_torch.ops import raster_tiled as rt

    bin_rejected = dict.fromkeys(BIN_FAULTS, 0)
    bin_split_rejected = dict.fromkeys(BIN_SPLIT_FAULTS, 0)  # planted faults of B6's two passes
    for n_b, w_b, h_b in BIN_SCENES:
        scene_b = random_bin_scene(torch, n_b, w_b, h_b)
        for k_b in (128, 256):
            bin_checks(torch, rc, rt, scene_b, k_b, (0, 128, 256),
                       f"bin scene of {n_b} splats at {w_b}x{h_b}", bin_rejected,
                       bin_split_rejected)
    gate_n = GATE_SCENE_BLOCKS * rc.BIN_BLOCK
    bin_checks(torch, rc, rt, random_bin_scene(torch, gate_n, RES, RES), K_PER_TILE, (0, 128, 256),
               f"bin scene of {gate_n} splats at {RES}x{RES}", bin_rejected, bin_split_rejected)
    if not all(bin_rejected.values()):
        raise AssertionError(f"a planted bin fault never showed on the random scenes: {bin_rejected}")
    if not all(bin_split_rejected.values()):
        raise AssertionError(f"a planted fault of B6's two passes never showed on the random "
                             f"scenes: {bin_split_rejected}")
    del scene_b
    torch.cuda.synchronize()
    gather_entry = gather_bwd_checks(torch, rc, card)

    # ---- phase 3: the kernels on the main path's inputs at 256x256 ------ #
    from activesplat_tpu_torch.queries.panorama import global_invisibility
    from activesplat_tpu_torch.queries.topdown import render_topdown, topdown_config_from_bbox
    from activesplat_tpu_torch.runtime.bench_scene import build_map
    from activesplat_tpu_torch.utils.transforms import rot_axis

    scene = build_map(N_GAUSSIANS, RES, k_per_tile=K_PER_TILE)
    exact_render_check(torch, rc, scene.buf, scene.cam)
    (rows, u0, v0), (stream, n_tiles), prefix = render_inputs(torch, rc, rt, scene.buf, scene.cam,
                                                              K_PER_TILE)
    where = f"main path {RES}x{RES}"
    measured = tile_entries(torch, rc, rows, u0, v0, where, rejected, rates)
    measured += csr_entries(torch, rc, stream, n_tiles, where, rejected, rates)
    measured.append(bin_entry(torch, rc, rt, prefix, K_PER_TILE, where, rates, card))
    # the bins of phases 3 and 5, on the host, as bin_gaussians takes them
    bin_inputs = {where: tuple(x.cpu() if hasattr(x, "cpu") else x for x in prefix)
                  + (K_PER_TILE, 0)}
    del rows, u0, v0, stream, prefix
    qbuf = build_map(QUERY_GAUSSIANS, RES).buf
    td_cfg = topdown_config_from_bbox(np.array(QUERY_BBOX), agent_foot=0.0, agent_head=1.5,
                                      pixel_max=360)
    [(stream, n_tiles, _)] = capture_streams("blend_csr_dual_fwd",
                                             lambda: render_topdown(qbuf, td_cfg))
    measured.append(dual_entry(torch, rc, stream, n_tiles, f"top-down query, {QUERY_GAUSSIANS} "
                               f"Gaussians", rejected, rates))
    # the six views of one global_invisibility call (60x75 px in 4x5 tiles):
    # unlike the mapping stream, their edge tiles never saturate and walk
    # their whole run; B3 is held on the view with the most walked pairs
    pano = capture_streams("blend_csr", lambda: global_invisibility(
        qbuf, query_pose(np, QUERY_VIEW), np.array(QUERY_NODES), scale=0.5))
    walked = [csr_pair_counts(torch, rc, st, rc.blend_csr_fwd(*st, nt, c, with_entry=True)[2],
                              nt)[1] for st, nt, c in pano]
    big = max(range(len(pano)), key=walked.__getitem__)
    stream, n_tiles, c = pano[big]
    measured += csr_entries(torch, rc, stream, n_tiles, f"panorama view {big} of {len(pano)}",
                            rejected, rates, c=c, with_bwd=False)
    del pano, stream

    # ---- phase 4: the multi-device path on a virtual mesh --------------- #
    # two frames of the map's room for LPIPS in phase 6
    lpips_pair = [scene.world.render(rot_axis(scene.c2w, "y", np.deg2rad(a)), scene.intrinsics,
                                     RES, RES)[0] for a in (0.0, 30.0)]
    mesh_checks(torch, np, rc, scene, qbuf)
    del scene, qbuf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 5: the kernels at 512x512 --------------------------------- #
    mapper, cam, td_cfg = high_res_map(torch, np)
    (rows, u0, v0), (stream, n_tiles), prefix = render_inputs(torch, rc, rt, mapper.buf, cam,
                                                              HIGH_K)
    where = f"{HIGH_CONFIG} {HIGH_RES}x{HIGH_RES}"
    measured += tile_entries(torch, rc, rows, u0, v0, where, rejected, rates)
    measured += csr_entries(torch, rc, stream, n_tiles, where, rejected, rates)
    [(d_stream, d_tiles, _)] = capture_streams("blend_csr_dual_fwd",
                                               lambda: render_topdown(mapper.buf, td_cfg))
    measured.append(dual_entry(torch, rc, d_stream, d_tiles, where, rejected, rates))
    measured.append(bin_entry(torch, rc, rt, prefix, HIGH_K, where, rates, card))
    bin_inputs[where] = tuple(x.cpu() if hasattr(x, "cpu") else x for x in prefix) + (HIGH_K, 0)
    BIN_INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(bin_inputs, BIN_INPUTS)
    print(f"the bins {sorted(bin_inputs)} saved to {BIN_INPUTS} for scripts/bin_route_trace.py")
    del mapper, rows, u0, v0, stream, d_stream, prefix
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 6: the card against the CPU on small inputs -------------- #
    import tempfile

    from activesplat_tpu_torch.runtime.synthetic import BoxWorld

    small_scene_check(torch, np)
    for mode in ("on", "hybrid"):
        small_scene_check(torch, np, exact_training=mode, k_per_tile=16)
    small_query_check(torch, np)
    small_driver_check(torch, np, BoxWorld.two_room(seed=0))
    with tempfile.TemporaryDirectory() as small_dir:
        small_episode_check(torch, np, card, small_dir)
        small_judges_check(torch, np, card, small_dir)
    lpips_check(torch, np, card, *lpips_pair)
    habitat_small_check(torch, np, card)
    native_raycast_check(np, card)

    # ---- phase 7: the kernels' lines ------------------------------------- #
    print(f"planted faults rejected over phases 2-5: {rejected}")
    for e in measured:
        print(f"{e['name']} ({e['stream']}): max_abs_err={e['max_abs_err']:.3e} kernel "
              f"{e['ms']:.4f} ms {e['pass_ms']} (wrapper {e['wrapper_ms']:.4f} ms per call), twin "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}, "
              f"{e['bound_ms'] / e['ms']:.3f} of it reached) on {card}")
    torch.cuda.synchronize()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": measured}))
    print(json.dumps({"gather_bwd": gather_entry}))
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
