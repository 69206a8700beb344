"""The plain reference renderer: EWA projection and tile-binned front-to-back
compositing of 3D Gaussians in plain PyTorch, with the exact semantics the
program states (the reference package's Pallas kernels and their XLA
callers), written out again here. It imports nothing of the program.

What it reproduces, because each of these changes pixels:
- the projection (3-sigma radius, 0.3 px low-pass dilation, frustum clamp of
  the Jacobian, near/far and on-screen culls), term for term;
- the opacity-adaptive bin radius, the 1/8 px quantization of the binned
  means, the radius inflated by 2/8 px, and the stable depth sort;
- 16x16 tiles; per pixel alpha = min(0.99, o exp(power)), dropped where
  power > 0 or alpha < 1/255;
- the whole-tile early exit: a tile stops at the first segment start at
  which every pixel's log-transmittance is below -5.55, segments of 64 rows
  in the k-capped blend and 256 in the exact (CSR) blend;
- the k cap (each tile's nearest k), the hybrid rule (tiles that overflow
  the cap while a pixel's end-of-list log-transmittance is still above
  -5.55 are recomposited exactly), the entry budget min(4N, 2^23) and the
  fallbacks past it, and the dual walk of the top-down maps (a second
  transmittance over a band of Gaussians, the exit testing the band).

Segments are composited each from transmittance 1 and combined per tile,
which reassociates the sums against a sequential walk: rounding only.
Gradients come from autograd, in chunks of segments, so that a map of
millions of Gaussians at 512x512 fits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

TILE = 16
PX = TILE * TILE
SEG = 64
CSEG = 256
LOG_EPS = -5.55
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
SATURATED_LOG_T = math.log(0.02)
ENTRY_CAP = 1 << 23
COV2D_DILATION = 0.3
CHUNK_ELEMS = 1 << 25  # (segment, row, pixel) elements per chunk


class Cam(NamedTuple):
    w2c: torch.Tensor  # (4, 4)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.01
    far: float = 100.0


def quat_to_rotmat(q):
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def project(means3d, quats, log_scales, active, cam: Cam, scale_modifier: float = 1.0):
    """(mean2d (N, 2), conic (N, 3), radius (N,), depth (N,), valid (N,)).

    Written as the same float32 elementwise chain as the program states it,
    term for term, so that the camera depths come out bitwise alike: depth
    ties (a wall's Gaussians seen from the frame that made them) are broken
    by the stable sort in slot order, and a depth computed any other way
    breaks them otherwise."""
    r = cam.w2c[:3, :3]
    t = cam.w2c[:3, 3]
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    x = r[0, 0] * mx + r[0, 1] * my + r[0, 2] * mz + t[0]
    y = r[1, 0] * mx + r[1, 1] * my + r[1, 2] * mz + t[1]
    z = r[2, 0] * mx + r[2, 1] * my + r[2, 2] * mz + t[2]
    in_front = z > cam.near
    zs = torch.where(in_front, z, torch.ones_like(z))
    inv_z = 1.0 / zs
    fx, fy = _scalar(cam.fx, z), _scalar(cam.fy, z)
    cx, cy = _scalar(cam.cx, z), _scalar(cam.cy, z)
    mean_x = fx * x * inv_z + cx
    mean_y = fy * y * inv_z + cy
    mean2d = torch.stack([mean_x, mean_y], dim=-1)
    scales = (torch.exp(log_scales) * scale_modifier).expand(means3d.shape[0], 3)
    m = quat_to_rotmat(quats) * scales[:, None, :]
    a = [[r[i, 0] * m[:, 0, j] + r[i, 1] * m[:, 1, j] + r[i, 2] * m[:, 2, j] for j in range(3)]
         for i in range(3)]

    def dot_rows(i, j):
        return a[i][0] * a[j][0] + a[i][1] * a[j][1] + a[i][2] * a[j][2]

    c00, c01, c02 = dot_rows(0, 0), dot_rows(0, 1), dot_rows(0, 2)
    c11, c12, c22 = dot_rows(1, 1), dot_rows(1, 2), dot_rows(2, 2)
    lim_x = 1.3 * (0.5 * cam.width / fx)
    lim_y = 1.3 * (0.5 * cam.height / fy)
    tx = torch.clamp(x * inv_z, -lim_x, lim_x) * zs
    ty = torch.clamp(y * inv_z, -lim_y, lim_y) * zs
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z
    ca = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + COV2D_DILATION
    cb = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    cc = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + COV2D_DILATION
    det = ca * cc - cb * cb
    det_ok = det > 1e-12
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cc * inv_det, -cb * inv_det, ca * inv_det], dim=-1)
    mid = 0.5 * (ca + cc)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    on_screen = ((mean_x + radius > 0) & (mean_x - radius < cam.width)
                 & (mean_y + radius > 0) & (mean_y - radius < cam.height))
    valid = active & in_front & (z < cam.far) & det_ok & on_screen
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return mean2d, conic, radius, z, valid


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A camera constant as a 0-d float32 tensor, as the camera holds it."""
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def bin_radius(radius, valid, opacity):
    """The opacity-adaptive cull radius and validity used for binning."""
    radius, opacity = radius.detach(), opacity.detach()
    ln = torch.log(torch.clamp(255.0 * opacity, min=1e-20))
    r_eff = torch.sqrt(torch.clamp(2.0 * ln, min=0.0)) * (radius / 3.0)
    visible = opacity > ALPHA_MIN
    return torch.where(visible, torch.minimum(radius, r_eff), torch.zeros_like(radius)), \
        valid & visible


class Members(NamedTuple):
    """Every (tile, Gaussian) membership of the visible prefix, grouped by
    tile and depth-ordered within each tile."""
    tile: torch.Tensor  # (M,) int64
    gid: torch.Tensor  # (M,) int64 Gaussian index
    rank: torch.Tensor  # (M,) position within its tile's list
    count: torch.Tensor  # (T,) members per tile
    sorted_tiles: tuple  # (tx0, tx1, ty0, ty1, inside) of each visible Gaussian, depth order
    order: torch.Tensor  # (b,) Gaussian ids of the visible prefix, depth order
    n_tiles: int
    tiles_x: int


def memberships(mean2d, radius, valid, depth, width, height) -> Members:
    """Sort by depth (invalid last, stable), quantize as the bin packs, and
    expand every tile rectangle."""
    dev = mean2d.device
    mean2d, radius, depth = mean2d.detach(), radius.detach(), depth.detach()
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    order = torch.argsort(key, stable=True)
    b = int(valid.sum())
    order = order[:b]
    lim = float(2**15 - 2)
    q = torch.clamp(torch.round(mean2d[order] * 8.0), -lim, lim) / 8.0
    rad = radius[order] + 0.25
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    mx, my = q[:, 0], q[:, 1]
    inside = ((mx + rad >= 0) & (mx - rad < tiles_x * TILE) & (my + rad >= 0)
              & (my - rad < tiles_y * TILE))
    tx0 = torch.clamp(torch.floor((mx - rad) / TILE), 0, tiles_x - 1).long()
    tx1 = torch.clamp(torch.floor((mx + rad) / TILE), 0, tiles_x - 1).long()
    ty0 = torch.clamp(torch.floor((my - rad) / TILE), 0, tiles_y - 1).long()
    ty1 = torch.clamp(torch.floor((my + rad) / TILE), 0, tiles_y - 1).long()
    span_x = tx1 - tx0 + 1
    span = torch.where(inside, span_x * (ty1 - ty0 + 1), 0)
    total = int(span.sum())
    sid = torch.repeat_interleave(torch.arange(b, device=dev), span, output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(span, 0) - span)[sid]
    tile = (ty0[sid] + local // span_x[sid]) * tiles_x + tx0[sid] + local % span_x[sid]
    tile, perm = torch.sort(tile, stable=True)
    sid = sid[perm]
    t = tiles_x * tiles_y
    count = torch.bincount(tile, minlength=t)
    rank = torch.arange(total, device=dev) - (torch.cumsum(count, 0) - count)[tile]
    return Members(tile, order[sid], rank, count, (tx0, tx1, ty0, ty1, inside), order, t,
                   tiles_x)


class Layout(NamedTuple):
    """Segments of `seg` rows: (n_seg, seg) Gaussian ids (-1 = padding), each
    segment's tile and its position among its tile's segments."""
    ids: torch.Tensor
    seg_tile: torch.Tensor
    seg_pos: torch.Tensor
    seg: int


def _layout(tile, gid, slot, n_slots_per_tile, seg, n_tiles) -> Layout:
    """Rows at list positions `slot` of their tiles, tiles padded to
    n_slots_per_tile (T,) rows rounded up to `seg`."""
    dev = tile.device
    n_seg_t = -(-n_slots_per_tile // seg)
    seg_end = torch.cumsum(n_seg_t, 0)
    n_seg = int(seg_end[-1]) if n_tiles else 0
    ids = torch.full((n_seg * seg,), -1, dtype=torch.int64, device=dev)
    ids[(seg_end - n_seg_t)[tile] * seg + slot] = gid
    seg_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), n_seg_t,
                                       output_size=n_seg)
    seg_pos = torch.arange(n_seg, device=dev) - (seg_end - n_seg_t)[seg_tile]
    return Layout(ids.view(n_seg, seg), seg_tile, seg_pos, seg)


def capped_layout(m: Members, k: int, offset: int = 0) -> tuple:
    """The k-window [offset, offset + k) of every tile's list, in SEG
    segments (k padded to a SEG multiple). Returns (layout, overflow (T,))."""
    keep = (m.rank >= offset) & (m.rank < offset + k)
    slots = torch.full((m.n_tiles,), -(-k // SEG) * SEG, dtype=torch.int64, device=m.tile.device)
    lay = _layout(m.tile[keep], m.gid[keep], m.rank[keep] - offset, slots, SEG, m.n_tiles)
    return lay, torch.clamp(m.count - offset - k, min=0)


def entry_budget(n: int) -> int:
    return -(-max(min(4 * n, ENTRY_CAP), CSEG) // CSEG) * CSEG


def kept_gaussians(m: Members, n: int, harm=None):
    """The CSR expansion's cut under the entry budget min(4N, 2^23), at
    Gaussian granularity in depth order: (kept (N,) bool by Gaussian id,
    memberships dropped). With `harm` (T,) only Gaussians whose rectangle
    covers a harmful tile spend budget."""
    tx0, tx1, ty0, ty1, inside = m.sorted_tiles
    use = inside
    if harm is not None:
        tiles_y = m.n_tiles // m.tiles_x
        grid = torch.nn.functional.pad(
            harm.view(tiles_y, m.tiles_x).long().cumsum(0).cumsum(1), (1, 0, 1, 0))
        covered = (grid[ty1 + 1, tx1 + 1] - grid[ty0, tx1 + 1] - grid[ty1 + 1, tx0]
                   + grid[ty0, tx0])
        use = use & (covered > 0)
    span = torch.where(use, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    g_end = torch.cumsum(span, 0)
    kept = g_end <= entry_budget(n)
    dropped = int(g_end[-1] - torch.where(kept, g_end, 0).max()) if len(g_end) else 0
    by_id = torch.zeros(n, dtype=torch.bool, device=m.order.device)
    by_id[m.order[kept & use]] = True
    return by_id, dropped


def csr_from_members(m: Members, kept: torch.Tensor, tiles_sel: torch.Tensor) -> Layout:
    """CSEG segments of the selected tiles' members whose Gaussian is kept."""
    keep = kept[m.gid] & tiles_sel[m.tile]
    tile, gid = m.tile[keep], m.gid[keep]
    count = torch.bincount(tile, minlength=m.n_tiles)
    rank = torch.arange(len(tile), device=tile.device) - (torch.cumsum(count, 0) - count)[tile]
    return _layout(tile, gid, rank, count, CSEG, m.n_tiles)


def tile_pixels(seg_tile, tiles_x):
    local = torch.arange(PX, device=seg_tile.device)
    u0 = (seg_tile % tiles_x) * TILE
    v0 = torch.div(seg_tile, tiles_x, rounding_mode="floor") * TILE
    return ((u0[:, None] + local % TILE).float(), (v0[:, None] + local // TILE).float())


def segment_partials(table, ids, px, py, n_ch, band=None):
    """Each segment composited from transmittance 1: (P (S, PX, C), L (S, PX)
    [, L_band (S, PX)]). table: (N, 6 + C) [mean2d, conic, opacity, colours];
    ids (S, R) with -1 for padding rows."""
    live = ids >= 0
    rows = table[ids.clamp(min=0)]  # (S, R, 6 + C)
    dx = rows[:, :, 0:1] - px[:, None, :]
    dy = rows[:, :, 1:2] - py[:, None, :]
    ca, cb, cc, op = (rows[:, :, i:i + 1] for i in range(2, 6))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where(live[:, :, None] & (power <= 0) & (alpha >= ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
    logs = torch.log1p(-alpha)
    cum = torch.cumsum(logs, 1)
    w = alpha * torch.exp(cum - logs)
    part = torch.einsum("srp,src->spc", w, rows[:, :, 6:6 + n_ch])
    if band is None:
        return part, cum[:, -1]
    band_rows = (band[ids.clamp(min=0)] & live).float()[:, :, None]
    return part, cum[:, -1], torch.log1p(-alpha * band_rows).sum(1)


def _chunks(n_seg, rows):
    step = max(1, CHUNK_ELEMS // (rows * PX))
    for s in range(0, n_seg, step):
        yield slice(s, min(s + step, n_seg))


def all_partials(table, lay: Layout, tiles_x, n_ch, band=None):
    outs = []
    for sl in _chunks(lay.ids.shape[0], lay.seg):
        px, py = tile_pixels(lay.seg_tile[sl], tiles_x)
        outs.append(segment_partials(table, lay.ids[sl], px, py, n_ch, band))
    if not outs:
        z = table.new_zeros((0, PX))
        return (table.new_zeros((0, PX, n_ch)), z) + ((z,) if band is not None else ())
    return tuple(torch.cat(x, 0) for x in zip(*outs))


def combine(lay: Layout, n_tiles, part, step, band_step=None):
    """Per-tile front-to-back combine with the whole-tile exit (tested on the
    band's transmittance when there is one): (accum (T, PX, C), logT (T, PX)
    [, logT_band]). Differentiable in part and step."""
    n_seg_max = int(lay.seg_pos.max()) + 1 if len(lay.seg_pos) else 1
    dev = part.device
    c = part.shape[-1]
    idx = lay.seg_tile * n_seg_max + lay.seg_pos

    def dense(x, shape):
        out = x.new_zeros((n_tiles * n_seg_max,) + shape)
        return out.index_copy(0, idx, x).view((n_tiles, n_seg_max) + shape)

    p, s = dense(part, (PX, c)), dense(step, (PX,))
    prefix = torch.cat([torch.zeros_like(s[:, :1]), torch.cumsum(s, 1)[:, :-1]], 1)
    test = prefix
    if band_step is not None:
        sb = dense(band_step, (PX,))
        prefix_b = torch.cat([torch.zeros_like(sb[:, :1]), torch.cumsum(sb, 1)[:, :-1]], 1)
        test = prefix_b
    walk = (test.detach().amax(2) >= LOG_EPS).float()  # (T, S)
    accum = (walk[:, :, None, None] * torch.exp(prefix)[..., None] * p).sum(1)
    logt = (walk[:, :, None] * s).sum(1)
    if band_step is None:
        return accum, logt
    return accum, logt, (walk[:, :, None] * sb).sum(1)


def to_image(x_t, tiles_x, width, height):
    """(T, PX, ...) tile blocks -> (H, W, ...) image."""
    tiles_y = x_t.shape[0] // tiles_x
    rest = x_t.shape[2:]
    img = x_t.reshape((tiles_y, tiles_x, TILE, TILE) + rest).transpose(1, 2)
    return img.reshape((tiles_y * TILE, tiles_x * TILE) + rest)[:height, :width]


def from_image(img, tiles_x):
    h, w = img.shape[:2]
    rest = img.shape[2:]
    tiles_y = h // TILE
    return img.reshape((tiles_y, TILE, tiles_x, TILE) + rest).transpose(1, 2).reshape(
        (tiles_y * tiles_x, PX) + rest)


def capped_multipass(table, m: Members, k, n_ch, tiles_x, max_passes):
    """The capped blend over up to max_passes k-windows, folded front to back
    until every overflowing tile saturates (log T <= log 0.02) or exhausts."""
    lay, overflow = capped_layout(m, k, 0)
    accum, logt = combine(lay, m.n_tiles, *all_partials(table, lay, tiles_x, n_ch))
    for p in range(1, max_passes):
        unsat = logt.amax(1) > SATURATED_LOG_T
        if not bool(((overflow > 0) & unsat).any()):
            break
        lay, overflow = capped_layout(m, k, p * k)
        acc_p, logt_p = combine(lay, m.n_tiles, *all_partials(table, lay, tiles_x, n_ch))
        accum = accum + torch.exp(logt)[:, :, None] * acc_p
        logt = logt + logt_p
    return accum, logt


def render_forward(table, m: Members, n_ch, mode, k, band=None):
    """Forward composite of a render. mode: "capped" (the k cap), "exact"
    (every membership; past the entry budget the multi-pass capped walk),
    "hybrid" (capped, harmful tiles exact; past the budget capped). Returns
    (accum_t, logt_t[, logt_band_t], branches) with branches [(layout, tiles)]
    naming the layout each tile's output came from."""
    t, tiles_x, order, n = m.n_tiles, m.tiles_x, m.order, table.shape[0]
    all_tiles = torch.ones(t, dtype=torch.bool, device=table.device)
    b = len(order)
    if mode == "exact":
        kept, dropped = kept_gaussians(m, n)
        if dropped:
            kk = max(int(k), 1)
            passes = -(-n // kk)
            kk = min(kk, b)
            accum, logt = capped_multipass(table, m, kk, n_ch, tiles_x, passes)
            if band is None:
                return accum, logt, None
            band_table = table.clone()
            band_table[:, 5] = table[:, 5] * band.float()
            _, logt_b = capped_multipass(band_table, m, kk, n_ch, tiles_x, passes)
            return accum, logt, logt_b, None
        lay = csr_from_members(m, kept, all_tiles)
        parts = all_partials(table, lay, tiles_x, n_ch, band)
        out = combine(lay, t, *parts)
        return (*out, [(lay, all_tiles)])
    kk = min(int(k), b) if b else 1
    lay, overflow = capped_layout(m, kk, 0)
    accum, logt = combine(lay, t, *all_partials(table, lay, tiles_x, n_ch))
    branches = [(lay, all_tiles)]
    if mode == "hybrid":
        harm = (overflow > 0) & (logt.amax(1) > LOG_EPS)
        if bool(harm.any()):
            kept, dropped = kept_gaussians(m, n, harm)
            if not dropped:
                lay_h = csr_from_members(m, kept, harm)
                acc_h, logt_h = combine(lay_h, t, *all_partials(table, lay_h, tiles_x, n_ch))
                accum = torch.where(harm[:, None, None], acc_h, accum)
                logt = torch.where(harm[:, None], logt_h, logt)
                branches = [(lay, ~harm), (lay_h, harm)]
    elif mode != "capped":
        raise ValueError(f"unknown render mode {mode!r}")
    return accum, logt, branches


def backward_into_table(branches, g_accum_t, g_logt_t, table, tiles_x, n_tiles, n_ch):
    """d loss / d table (N, 6 + C) from the tiles' cotangents, each tile's
    cotangent routed to the branch that made its output; partials are
    recomputed chunk by chunk with autograd."""
    grad = torch.zeros_like(table)
    for lay, tiles in branches:
        sel = tiles.float()
        with torch.no_grad():
            part, step = all_partials(table, lay, tiles_x, n_ch)
        part = part.requires_grad_(True)
        step = step.requires_grad_(True)
        accum, logt = combine(lay, n_tiles, part, step)
        torch.autograd.backward([accum, logt], [g_accum_t * sel[:, None, None],
                                                g_logt_t * sel[:, None]])
        g_part, g_step = part.grad, step.grad
        leaf = table.detach().requires_grad_(True)
        for sl in _chunks(lay.ids.shape[0], lay.seg):
            px, py = tile_pixels(lay.seg_tile[sl], tiles_x)
            p_c, s_c = segment_partials(leaf, lay.ids[sl], px, py, n_ch)
            torch.autograd.backward([p_c, s_c], [g_part[sl], g_step[sl]])
        grad += leaf.grad
    return grad
