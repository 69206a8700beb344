"""The plain reference of what the window's timed path produced, and the
numbers that decide `correct`.

Each check takes one capture (the program's inputs and outputs of one call,
copied while the window ran; benchmark/harness/capture.py) and works the
outputs out again from the inputs, in plain PyTorch (reference/render.py),
never from anything the program derived:

- `mapping_iteration`: a mapping iteration's render (the k-capped blend, or
  the hybrid with its exact recompositing), its loss (masked depth L1, L1
  and SSIM), the gradients the optimizer got and the Adam step;
- `densify`: the densification's exact render and the pixels it turns into
  new Gaussians;
- `topdown`: the top-down free and unobserved maps the planner read (the
  dual walk over the height band);
- `panorama`: the panorama views' quantized opacity behind the planner's
  invisibility scores.

`precision="tf32"` computes the reference with TF32 matrix products and
convolutions: the control, the nearest precision below the float32 with
TF32 off that the configuration states.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import render as R

LEAVES = ("means3d", "rgb", "quats", "logit_opacities", "log_scales")
# a leaf whose reference gradient norm is below this share of the median
# leaf's moves under Adam by round-off alone and is left out of the change
NEGLIGIBLE_LEAF = 1e-3


@contextlib.contextmanager
def precision(mode: str):
    """float32 with TF32 off ("fp32"), or the control with TF32 on ("tf32")."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = {"fp32": False, "tf32": True}[mode]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def camera(c: Dict) -> R.Cam:
    return R.Cam(c["w2c"], float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]),
                 int(c["width"]), int(c["height"]), float(c["near"]), float(c["far"]))


def _table(params: Dict, active, cam: R.Cam, scale_modifier=1.0, colors="rgbd"):
    """The per-Gaussian attribute table [mean2d, conic, opacity, colours]
    with the bin's radius and validity."""
    mean2d, conic, radius, depth, valid = R.project(
        params["means3d"], params["quats"], params["log_scales"], active, cam, scale_modifier)
    opacity = torch.sigmoid(params["logit_opacities"])
    if colors == "rgbd":
        cols = torch.cat([params["rgb"], depth[:, None], (depth * depth)[:, None]], -1)
    else:
        cols = params["rgb"]
    table = torch.cat([mean2d, conic, opacity[:, None], cols], -1)
    radius_b, valid_b = R.bin_radius(radius, valid, opacity)
    return table, radius_b, valid_b, depth, radius


def _members(table, radius_b, valid_b, depth, cam):
    return R.memberships(table[:, :2], radius_b, valid_b, depth, cam.width, cam.height)


def render_image(params, active, cam, mode, k, scale_modifier=1.0, band=None, colors="rgbd"):
    """Forward render: [accum (H, W, C), logT (H, W)(, logT_band)]."""
    with torch.no_grad():
        table, radius_b, valid_b, depth, _ = _table(params, active, cam, scale_modifier, colors)
        m = _members(table, radius_b, valid_b, depth, cam)
        out = R.render_forward(table, m, table.shape[1] - 6, mode, k, band)
    return [R.to_image(x, m.tiles_x, cam.width, cam.height) for x in out[:-1]]


def _gaussian_window(size=11, sigma=1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(a, b, size=11, sigma=1.5):
    """Mean SSIM of (H, W, C) images: separable Gaussian blur, zero padding,
    C1 = 0.01^2, C2 = 0.03^2."""
    g = torch.tensor(_gaussian_window(size, sigma), device=a.device)
    c = a.shape[-1]

    def blur(x):  # (H, W, C) -> (H, W, C)
        x = x.permute(2, 0, 1)[None]
        x = F.conv2d(x, g.view(1, 1, size, 1).expand(c, 1, size, 1), padding=(size // 2, 0),
                     groups=c)
        x = F.conv2d(x, g.view(1, 1, 1, size).expand(c, 1, 1, size), padding=(0, size // 2),
                     groups=c)
        return x[0].permute(1, 2, 0)

    mu_a, mu_b = blur(a), blur(b)
    s_aa = blur(a * a) - mu_a * mu_a
    s_bb = blur(b * b) - mu_b * mu_b
    s_ab = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    score = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (s_aa + s_bb + c2))
    return score.mean()


def mapping_loss(rgb, depth, im_gt, depth_gt, cfg):
    mask = (depth_gt > 0).float()
    depth_l1 = (torch.abs(depth_gt - depth) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    rgb_l1 = torch.abs(rgb - im_gt).mean()
    loss_im = 0.8 * rgb_l1 + 0.2 * (1.0 - ssim(rgb, im_gt))
    return cfg["loss_w_im"] * loss_im + cfg["loss_w_depth"] * depth_l1


def training_mode(cfg) -> str:
    if cfg["exact_training"] == "hybrid":
        return "hybrid"
    if cfg["exact_training"] == "on":
        return "exact"
    return "capped"


def loss_and_grads(params, active, cam, im_gt, depth_gt, cfg, rows: Optional[slice] = None):
    """The mapping loss and d loss / d params, the render differentiated by
    chunks of segments (render.backward_into_table)."""
    if cfg["use_sil_for_loss"] or cfg["ignore_outlier_depth_loss"] or cfg["k_per_tile"] <= 0:
        raise ValueError("the reference covers the mapper's default loss and tiled render")
    mode = training_mode(cfg)
    k = cfg["k_per_tile"]
    with torch.no_grad():
        table, radius_b, valid_b, depth, _ = _table(params, active, cam)
        m = _members(table, radius_b, valid_b, depth, cam)
        accum_t, logt_t, branches = R.render_forward(table, m, 5, mode, k)
        if mode == "exact" and branches is None:
            # past the entry budget the differentiable exact render falls back
            accum_t, logt_t, branches = R.render_forward(table, m, 5, "capped", k)
    accum = R.to_image(accum_t, m.tiles_x, cam.width, cam.height).requires_grad_(True)
    logt = R.to_image(logt_t, m.tiles_x, cam.width, cam.height).requires_grad_(True)
    rows = rows or slice(None)
    loss = mapping_loss(accum[rows, :, :3], accum[rows, :, 3], im_gt[rows], depth_gt[rows], cfg)
    g_accum, g_logt = torch.autograd.grad(loss, (accum, logt), allow_unused=True)
    g_logt = torch.zeros_like(logt) if g_logt is None else g_logt
    leaves = {k_: params[k_].detach().requires_grad_(True) for k_ in LEAVES}
    table_g, _, _, _, _ = _table(leaves, active, cam)
    g_table = R.backward_into_table(
        branches, R.from_image(g_accum, m.tiles_x), R.from_image(g_logt, m.tiles_x),
        table_g.detach(), m.tiles_x, m.n_tiles, 5)
    torch.autograd.backward(table_g, g_table)
    return float(loss.detach()), {k_: leaves[k_].grad for k_ in LEAVES}


def adam_step(params, grads, state, lrs, b1, b2, eps):
    """One bias-corrected Adam step (torch.optim.Adam's arithmetic, the bias
    corrections in float32)."""
    count = state["count"] + 1
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    out = {}
    for name in LEAVES:
        m = b1 * state["mu"][name] + (1.0 - b1) * grads[name]
        v = b2 * state["nu"][name] + (1.0 - b2) * grads[name] * grads[name]
        out[name] = params[name] - lrs[name] * (m / c1) / (torch.sqrt(v / c2) + eps)
    return out


def norm_gaps(prog: Dict, ref: Dict, ref_grads: Dict) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf; leaves whose reference gradient is negligible are left
    out."""
    g_norms = {k: float(torch.linalg.vector_norm(ref_grads[k])) for k in LEAVES}
    med_g = float(np.median(list(g_norms.values())))
    keep = [k for k in LEAVES if g_norms[k] >= NEGLIGIBLE_LEAF * med_g]
    p_n = {k: float(torch.linalg.vector_norm(prog[k])) for k in keep}
    r_n = {k: float(torch.linalg.vector_norm(ref[k])) for k in keep}
    med = float(np.median(list(r_n.values())))
    return max(abs(p_n[k] - r_n[k]) / max(r_n[k], med, 1e-30) for k in keep)


# --------------------------------------------------------------------------- #
# Each kind: the reference's outputs from the captured inputs, the program's
# outputs as captured, and the numbers that compare the two.
# --------------------------------------------------------------------------- #


def ref_iteration(cap: Dict, mode: str = "fp32", rows: Optional[slice] = None) -> Dict:
    """The reference's loss, gradients and Adam step; `rows` restricts the
    loss to a band of image rows (the half-batch fault)."""
    cam = camera(cap["cam"])
    im, dep = cap["im"], cap["depth"]
    with precision(mode):
        loss, grads = loss_and_grads(cap["pre"], cap["active"], cam, im, dep, cap["cfg"], rows)
        c = cap["cfg"]
        post = adam_step(cap["pre"], grads, cap["adam"], c["lrs"], c["adam_b1"], c["adam_b2"],
                         c["adam_eps"])
    return {"loss": loss, "grads": grads, "post": post}


def prog_iteration(cap: Dict) -> Dict:
    return {"loss": cap["loss"], "grads": cap["grads"], "post": cap["post"]}


def cmp_iteration(cap: Dict, prog: Dict, ref: Dict) -> Dict[str, float]:
    pre = cap["pre"]
    return {
        "loss_gap": abs(prog["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30),
        "grad_gap": norm_gaps(prog["grads"], ref["grads"], ref["grads"]),
        "step_gap": norm_gaps({k: prog["post"][k] - pre[k] for k in LEAVES},
                              {k: ref["post"][k] - pre[k] for k in LEAVES}, ref["grads"]),
    }


def ref_densify(cap: Dict, mode: str = "fp32") -> Dict:
    """The densification's exact render and the candidate pixels it turns
    into Gaussians (silhouette below sil_thres, or the map rendering well
    behind the frame's depth)."""
    cam = camera(cap["cam"])
    cfg = cap["cfg"]
    with precision(mode):
        accum, logt = render_image(cap["pre"], cap["active"], cam, "exact", cfg["k_per_tile"])
    depth_gt = cap["depth"]
    sil = 1.0 - torch.exp(logt)
    out_depth = accum[..., 3]
    err = torch.abs(depth_gt - out_depth) * (depth_gt > 0)
    med = torch.quantile(err.reshape(-1), 0.5)
    non_presence = (sil < cfg["sil_thres"]) | (
        (out_depth > depth_gt) & (err > 2.0 * med) & (sil > cfg["sil_thres"])
        & (depth_gt < cfg["new_gaussian_depth_limit"]))
    return {"mask": non_presence & (depth_gt > 0)}


def prog_densify(cap: Dict) -> Dict:
    return {"mask": cap["chosen"]}


def cmp_densify(cap: Dict, prog: Dict, ref: Dict) -> Dict[str, float]:
    return {"densify_px": float((prog["mask"] != ref["mask"]).float().mean())}


def topdown_camera(tc: Dict, device) -> R.Cam:
    """The near-orthographic camera 1000 m above the grid's centre."""
    h = tc["height_axis"]
    du, dv = tc["world_dim_index"]
    x_cam = np.zeros(3)
    x_cam[du] = 1.0
    z_cam = np.zeros(3)
    z_cam[h] = -1.0
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = x_cam, np.cross(z_cam, x_cam), z_cam
    c2w[du, 3], c2w[dv, 3], c2w[h, 3] = tc["world_center"][0], tc["world_center"][1], 1000.0
    f = 1000.0 / tc["meter_per_pixel"]
    w, hgt = tc["grid_shape"]
    w2c = torch.tensor(np.linalg.inv(c2w), dtype=torch.float32, device=device)
    return R.Cam(w2c, f, f, w / 2 - 0.5, hgt / 2 - 0.5, w, hgt, 0.01, 2000.0)


def ref_topdown(cap: Dict, mode: str = "fp32") -> Dict:
    """The free map (the height band's opacity <= 0.4, splats shrunk to 1%)
    and the unobserved map (pure white in a white-background colour render)
    from one dual walk."""
    tc = cap["topdown_cfg"]
    pre = cap["pre"]
    cam = topdown_camera(tc, pre["means3d"].device)
    h = pre["means3d"][:, tc["height_axis"]]
    foot = torch.tensor(np.float32(tc["foot"]), device=h.device)
    head = torch.tensor(np.float32(tc["agent_head"]), device=h.device)
    band = (h >= foot) & (h <= head)
    with precision(mode):
        accum, logt, logt_band = render_image(pre, cap["active"], cam, "exact", 256,
                                              scale_modifier=0.01, band=band, colors="rgb")
    free_alpha = 1.0 - torch.exp(logt_band)
    rgb = accum[..., :3] + torch.exp(logt)[..., None]
    rgb_u8 = torch.floor(torch.clamp(rgb, 0.0, 1.0) * 255.0)
    gray = torch.round(0.299 * rgb_u8[..., 0] + 0.587 * rgb_u8[..., 1] + 0.114 * rgb_u8[..., 2])
    return {"free": (free_alpha <= 0.4).to(torch.uint8),
            "unobserved": (gray == 255.0).to(torch.uint8)}


def prog_topdown(cap: Dict) -> Dict:
    dev = cap["pre"]["means3d"].device
    return {k: torch.as_tensor(cap[k], device=dev) for k in ("free", "unobserved")}


def cmp_topdown(cap: Dict, prog: Dict, ref: Dict) -> Dict[str, float]:
    differ = sum(int((prog[k] != ref[k]).sum()) for k in ("free", "unobserved"))
    return {"topdown_px": differ / (2 * ref["free"].numel())}


def pano_camera(scale: float, w2c: torch.Tensor) -> R.Cam:
    """The panorama view camera: 120 x 150 degrees, one pixel a degree at
    scale 1, with the Habitat principal point W/2 - 1."""
    w, h = int(round(120 * scale)), int(round(150 * scale))
    fx = 0.5 * w / np.tan(np.deg2rad(120.0) / 2.0)
    fy = 0.5 * h / np.tan(np.deg2rad(150.0) / 2.0)
    return R.Cam(w2c, fx, fy, w / 2 - 1, h / 2 - 1, w, h, 0.01, 100.0)


def ref_panorama(cap: Dict, mode: str = "fp32") -> Dict:
    """Each view's exact render, its opacity quantized to 8 bits."""
    pre = cap["pre"]
    w2cs = torch.tensor(np.linalg.inv(cap["c2ws"]), dtype=torch.float32,
                        device=pre["means3d"].device)
    out = []
    for w2c in w2cs:
        with precision(mode):
            _, logt = render_image(pre, cap["active"], pano_camera(cap["scale"], w2c), "exact",
                                   256)
        out.append(torch.round(torch.clamp(1.0 - torch.exp(logt), 0.0, 1.0) * 255.0))
    return {"alpha_u8": torch.stack(out)}


def prog_panorama(cap: Dict) -> Dict:
    return {"alpha_u8": cap["alpha_u8"].float()}


def cmp_panorama(cap: Dict, prog: Dict, ref: Dict) -> Dict[str, float]:
    """The worst view's share of pixels more than one 8-bit step apart, so
    that a fault in one view is not diluted by the number of views."""
    differ = (torch.abs(prog["alpha_u8"] - ref["alpha_u8"]) > 1.0).float()
    return {"pano_px": float(differ.flatten(1).mean(1).max())}


KINDS = {
    "iteration": (ref_iteration, prog_iteration, cmp_iteration),
    "densify": (ref_densify, prog_densify, cmp_densify),
    "topdown": (ref_topdown, prog_topdown, cmp_topdown),
    "panorama": (ref_panorama, prog_panorama, cmp_panorama),
}


def _altered(kind: str, cap: Dict, ref: Dict) -> Dict:
    """The reference's outputs with one answer altered where it is made: a
    16x16 tile of the top-down free map flipped, a 16x16 tile of the first
    panorama view's opacity moved by 2 steps, a 16x16 tile of the
    densification's candidate pixels flipped, the rgb leaf's gradient
    doubled and its step made from that."""
    out = {k: (v.clone() if torch.is_tensor(v) else dict(v) if isinstance(v, dict) else v)
           for k, v in ref.items()}
    if kind == "topdown":
        out["free"][:16, :16] = 1 - out["free"][:16, :16]
    elif kind == "panorama":
        tile = out["alpha_u8"][0, :16, :16]
        out["alpha_u8"][0, :16, :16] = torch.where(tile <= 253, tile + 2, tile - 2)
    elif kind == "densify":
        out["mask"][:16, :16] = ~out["mask"][:16, :16]
    else:
        grads = dict(ref["grads"], rgb=2.0 * ref["grads"]["rgb"])
        c = cap["cfg"]
        out["grads"] = grads
        out["post"] = adam_step(cap["pre"], grads, cap["adam"], c["lrs"], c["adam_b1"],
                                c["adam_b2"], c["adam_eps"])
    return out


def variant_outputs(kind: str, cap: Dict, ref: Dict, variant: str) -> Dict:
    """What is compared with the reference: the program's outputs, or the
    control's (the reference under TF32), or a planted fault's."""
    make_ref, make_prog, _ = KINDS[kind]
    if variant == "program":
        return make_prog(cap)
    if variant == "control":
        return make_ref(cap, "tf32")
    if variant == "unchanged":
        if kind != "iteration":
            return ref
        return dict(ref, post=cap["pre"])
    if variant == "half_batch":
        if kind != "iteration":
            return ref
        h = cap["im"].shape[0]
        return ref_iteration(cap, "fp32", rows=slice(0, h // 2))
    if variant == "altered":
        return _altered(kind, cap, ref)
    raise ValueError(f"unknown variant {variant!r}")


def evaluate(captures: Dict[str, List[Dict]], variants=("program",)) -> Dict[str, Dict[str, float]]:
    """{variant: {number: worst over the captures}}. A kind with no capture
    (no call of it in the window) gives no number."""
    numbers: Dict[str, Dict[str, float]] = {v: {} for v in variants}
    for kind, caps in captures.items():
        make_ref, _, compare = KINDS[kind]
        for cap in caps:
            ref = make_ref(cap, "fp32")
            for v in variants:
                for name, value in compare(cap, variant_outputs(kind, cap, ref, v), ref).items():
                    numbers[v][name] = max(numbers[v].get(name, 0.0), value)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return numbers
