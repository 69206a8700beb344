"""The mapping computation: loss, one optimization iteration, the per-frame
mapping event with the optional mean2d gradient tap, first-frame
initialization, silhouette and gradient densification, and pruning
(counterpart of activesplat_tpu/mapper/step.py); with a mesh
(parallel/sharded.py) the mapping event's and the densification's renders
shard their rows over its devices.

Where the JAX package runs a mapping event as one compiled lax.scan, the port
runs a Python loop of iterations; every iteration stays on the device (the
keyframe draws for the whole event are made up front, so no iteration waits
for the host except the host reads of the tiled render).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from activesplat_tpu_torch.mapper.adam import AdamState, adam_update, lr_params
from activesplat_tpu_torch.mapper.config import MapperConfig
from activesplat_tpu_torch.mapper.geometry import gaussians_from_rgbd
from activesplat_tpu_torch.mapper.keyframes import KeyframeStore, select_keyframes_overlap
from activesplat_tpu_torch.models.gaussians import (
    Camera,
    GaussianBuffer,
    GaussianParams,
    insert_gaussians,
    prune_mask,
)
from activesplat_tpu_torch.ops.projection import project_gaussians
from activesplat_tpu_torch.ops.render import render, render_projected
from activesplat_tpu_torch.ops.ssim import psnr, ssim
from activesplat_tpu_torch.utils.tracing import stage


class LossAux(NamedTuple):
    rgb_l1: torch.Tensor
    depth_l1: torch.Tensor
    ssim: torch.Tensor
    radii: torch.Tensor
    psnr: torch.Tensor
    dropped: torch.Tensor  # harmful tile memberships cut by the k_per_tile cap


def mapping_loss(
    params: GaussianParams,
    buf: GaussianBuffer,
    cam: Camera,
    im_gt: torch.Tensor,  # (H, W, 3)
    depth_gt: torch.Tensor,  # (H, W)
    cfg: MapperConfig,
) -> Tuple[torch.Tensor, LossAux]:
    """Mapping loss (get_loss semantics for mapping=True, splatam.py:172-301):
    masked mean depth L1 + (0.8 L1 + 0.2 (1-SSIM)) RGB, black background.
    exact_training "on" trains through the exact CSR render and "hybrid"
    through the capped render with CSR recompositing of harmful tiles;
    "off" and "auto" train k-capped ("auto" until the mapper driver,
    mapper/splatam.py, switches its config to "hybrid")."""
    out = render(
        buf.replace(params=params),
        cam,
        chunk=cfg.chunk,
        k_per_tile=cfg.k_per_tile,
        grad_exact=_grad_exact(cfg),
    )
    return loss_from_render(out.rgb, out.depth, out.alpha, out.radii, out.dropped, im_gt,
                            depth_gt, cfg)


@stage("mapper/loss")
def loss_from_render(rgb, depth, alpha, radii, dropped, im_gt, depth_gt, cfg: MapperConfig):
    """The mapping loss of one rendered frame and its LossAux (shared by
    mapping_loss and the mesh's parallel/sharded.sharded_mapping_loss)."""
    mask = depth_gt > 0
    if cfg.ignore_outlier_depth_loss:
        depth_error = torch.abs(depth_gt - depth.detach()) * mask
        # the median of the two middle values, as jnp.median takes it
        mask = mask & (depth_error < 10.0 * torch.quantile(depth_error.reshape(-1), 0.5))
    if cfg.use_sil_for_loss:
        mask = mask & (alpha.detach() > cfg.sil_thres)
    mask = mask.to(torch.float32)

    depth_l1 = torch.sum(torch.abs(depth_gt - depth) * mask) / torch.clamp(
        mask.sum(), min=1.0
    )
    rgb_l1 = torch.mean(torch.abs(rgb - im_gt))
    ssim_val = ssim(rgb, im_gt)
    loss_im = 0.8 * rgb_l1 + 0.2 * (1.0 - ssim_val)
    loss = cfg.loss_w_im * loss_im + cfg.loss_w_depth * depth_l1
    aux = LossAux(
        rgb_l1=rgb_l1.detach(),
        depth_l1=depth_l1.detach(),
        ssim=ssim_val.detach(),
        radii=radii.detach(),
        psnr=psnr(rgb.detach(), im_gt),
        dropped=dropped,
    )
    return loss, aux


def _grad_exact(cfg: MapperConfig):
    if cfg.k_per_tile and cfg.exact_training == "hybrid":
        return "hybrid"
    return bool(cfg.k_per_tile) and cfg.exact_training == "on"


def mapping_loss_with_tap(
    params: GaussianParams,
    tap: torch.Tensor,  # (C, 2) zeros: the gradient tap on the projected means
    buf: GaussianBuffer,
    cam: Camera,
    im_gt: torch.Tensor,
    depth_gt: torch.Tensor,
    cfg: MapperConfig,
) -> Tuple[torch.Tensor, LossAux]:
    """mapping_loss with an explicit mean2d gradient tap: differentiating
    with respect to `tap` yields dLoss/d(mean2d), the densification signal
    the reference captures via rendervar['means2D'].retain_grad()
    (splatam.py:207-209). As in the JAX package (step.py:102-151), its
    render names no backend, so the capped tiles blend in the reference's
    XLA blend (autograd, no early exit; the CSR half of "on" and "hybrid"
    runs in B3/B4), and the depth mask is depth_gt > 0 alone."""
    proj = project_gaussians(
        params.means3d, params.quats, params.log_scales, buf.active,
        cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        near=cam.near, far=cam.far,
    )
    proj = proj._replace(mean2d=proj.mean2d + tap)
    out = render_projected(
        proj, params.rgb, torch.sigmoid(params.logit_opacities), cam,
        chunk=cfg.chunk, k_per_tile=cfg.k_per_tile, grad_exact=_grad_exact(cfg),
        xla_blend=True,
    )
    mask = (depth_gt > 0).to(torch.float32)
    depth_l1 = torch.sum(torch.abs(depth_gt - out.depth) * mask) / torch.clamp(mask.sum(), min=1.0)
    rgb_l1 = torch.mean(torch.abs(out.rgb - im_gt))
    ssim_val = ssim(out.rgb, im_gt)
    loss = cfg.loss_w_im * (0.8 * rgb_l1 + 0.2 * (1.0 - ssim_val)) + cfg.loss_w_depth * depth_l1
    aux = LossAux(
        rgb_l1.detach(), depth_l1.detach(), ssim_val.detach(), out.radii.detach(),
        psnr(out.rgb.detach(), im_gt), out.dropped,
    )
    return loss, aux


def loss_and_grads(buf: GaussianBuffer, cam, im_gt, depth_gt, cfg, mesh=None):
    """(loss, aux, grads) of mapping_loss with respect to buf.params; with
    `mesh` (parallel/sharded.RenderMesh) of sharded_mapping_loss, the loss
    and aux brought to the map's device."""
    params = buf.params.map(lambda p: p.detach().requires_grad_(True))
    if mesh is None:
        loss, aux = mapping_loss(params, buf, cam, im_gt, depth_gt, cfg)
    else:
        from activesplat_tpu_torch.parallel.sharded import sharded_mapping_loss

        loss, aux = sharded_mapping_loss(params, buf, cam, im_gt, depth_gt, cfg, mesh)
        aux = LossAux(*(x.to(buf.device) for x in aux))
    with stage("mapper/grad"):
        grads = torch.autograd.grad(loss, params.tensors())
    return loss.detach().to(buf.device), aux, GaussianParams(*grads)


def loss_and_grads_with_tap(buf: GaussianBuffer, cam, im_gt, depth_gt, cfg):
    """(loss, aux, grads, tap gradient (C, 2)) of mapping_loss_with_tap."""
    params = buf.params.map(lambda p: p.detach().requires_grad_(True))
    tap = torch.zeros_like(buf.params.means3d[:, :2], requires_grad=True)
    loss, aux = mapping_loss_with_tap(params, tap, buf, cam, im_gt, depth_gt, cfg)
    *grads, g_tap = torch.autograd.grad(loss, (*params.tensors(), tap))
    return loss.detach(), aux, GaussianParams(*grads), g_tap


@stage("mapper/adam")
def _step(buf, opt_state, grads, aux, cfg) -> Tuple[GaussianBuffer, AdamState]:
    new_params, opt_state = adam_update(
        buf.params, grads, opt_state, lr_params(cfg),
        cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
    )
    seen = aux.radii > 0
    buf = buf.replace(
        params=new_params,
        max_radius=torch.where(
            seen, torch.maximum(buf.max_radius, aux.radii), buf.max_radius
        ),
    )
    return buf, opt_state


def mapping_iteration(
    buf: GaussianBuffer,
    opt_state: AdamState,
    cam: Camera,
    im_gt: torch.Tensor,
    depth_gt: torch.Tensor,
    cfg: MapperConfig,
):
    """One optimization iteration (render + loss + backward + Adam): the unit
    the reference times as 'Average Mapping/Iteration Time'
    (splatam/__init__.py:545-552). Returns (buf, opt_state, metrics)."""
    loss, aux, grads = loss_and_grads(buf, cam, im_gt, depth_gt, cfg)
    buf, opt_state = _step(buf, opt_state, grads, aux, cfg)
    return buf, opt_state, {
        "loss": loss,
        "psnr": aux.psnr,
        "depth_l1": aux.depth_l1,
        "dropped": aux.dropped,
    }


def _build_window(store: KeyframeStore, selected_ids, selected_valid):
    """Selected overlap keyframes + last committed keyframe + current frame
    (scratch slot), compacted valid-first (splatam/__init__.py:426-436)."""
    dev = selected_ids.device
    tail = torch.tensor(
        [max(store.count - 1, 0), store.scratch_slot], dtype=torch.int32, device=dev
    )
    window = torch.cat([selected_ids, tail])
    tail_valid = torch.tensor([store.count > 0, True], device=dev)
    wvalid = torch.cat([selected_valid, tail_valid])
    order = torch.argsort((~wvalid).to(torch.uint8), stable=True)
    return window[order], wvalid.sum()


def mapping_phase(
    buf: GaussianBuffer,
    store: KeyframeStore,
    cur_rgb: torch.Tensor,
    cur_depth: torch.Tensor,
    cur_w2c: torch.Tensor,
    cur_frame_id: int,
    cam: Camera,
    generator: torch.Generator,
    cfg: MapperConfig,
    num_iters: int,
    mesh=None,
):
    """One per-frame mapping event: keyframe selection, num_iters Adam
    iterations over keyframes drawn from the window, fresh optimizer state.
    `generator` lies on the store's device. With use_gs_densification each
    iteration also accumulates the mean2d gradient norm of every Gaussian it
    saw into grad_accum and denom (accumulate_mean2d_gradient,
    slam_external.py:100-108). `mesh` (parallel/sharded.RenderMesh) shards
    every training render's rows over its devices (sharded_mapping_loss);
    the draws are the same with and without it. Returns (buf, store,
    metrics)."""
    if mesh is not None and cfg.use_gs_densification:
        raise ValueError("the gradient-densification tap is single-device only; disable "
                         "use_gs_densification to map on a mesh")
    with stage("mapper/kf_window"):
        store = store.with_scratch(cur_rgb, cur_depth, cur_w2c, cur_frame_id)
        sel_ids, sel_valid = select_keyframes_overlap(
            store, cur_depth, cur_w2c, cam.fx, cam.fy, cam.cx, cam.cy, generator,
            num_select=cfg.mapping_window_size - 2,
            pixels=cfg.kf_select_pixels,
            edge=cfg.kf_select_edge,
        )
        window, n_valid = _build_window(store, sel_ids, sel_valid)
        # one uniform draw per iteration, made up front on the device
        draws = torch.rand(num_iters, generator=generator, device=window.device)
        picks = window[(draws * n_valid.clamp(min=1)).long().clamp(max=window.shape[0] - 1)]

    opt_state = AdamState.init(buf.params)  # fresh per event (splatam/__init__.py:440)
    rows = []
    for i in range(num_iters):
        idx = picks[i : i + 1]
        im = store.rgb.index_select(0, idx)[0]
        dep = store.depth.index_select(0, idx)[0]
        cam_i = cam.replace(w2c=store.w2c.index_select(0, idx)[0])
        if cfg.use_gs_densification:
            loss, aux, grads, g_tap = loss_and_grads_with_tap(buf, cam_i, im, dep, cfg)
        else:
            loss, aux, grads = loss_and_grads(buf, cam_i, im, dep, cfg, mesh=mesh)
        buf, opt_state = _step(buf, opt_state, grads, aux, cfg)
        if cfg.use_gs_densification:
            seen = aux.radii > 0
            buf = buf.replace(
                grad_accum=buf.grad_accum + torch.where(seen, torch.linalg.norm(g_tap, dim=-1), 0.0),
                denom=buf.denom + seen.to(torch.float32),
            )
        rows.append(
            torch.stack(
                [loss, aux.psnr, aux.depth_l1, aux.dropped.float(), aux.rgb_l1, aux.ssim]
            )
        )
    table = torch.stack(rows)  # (num_iters, 6)
    names = ("loss", "psnr", "depth_l1", "dropped", "rgb_l1", "ssim")
    metrics: Dict[str, torch.Tensor] = {k: table[:, i] for i, k in enumerate(names)}
    metrics["dropped"] = metrics["dropped"].to(torch.int32)
    metrics["num_window"] = n_valid
    # last-iteration scalars + the max of dropped in one tensor: the mapper's
    # per-frame bookkeeping reads this one value
    metrics["packed"] = torch.cat([table[-1, :3], table[:, 3].max()[None], table[-1, 4:]])
    return buf, store, metrics


@torch.no_grad()
def first_frame_phase(
    buf: GaussianBuffer,
    cam: Camera,
    rgb: torch.Tensor,
    depth_gt: torch.Tensor,
    cfg: MapperConfig,
):
    """Initialize the map from frame 0: one Gaussian per valid-depth pixel
    (initialize_first_timestep semantics, splatam.py:127-169).
    Returns (buf, num_dropped, scene_radius)."""
    c2w = torch.linalg.inv(cam.w2c)
    cand, valid = gaussians_from_rgbd(
        rgb, depth_gt, cam.fx, cam.fy, cam.cx, cam.cy, c2w,
        isotropic=cfg.gaussian_distribution == "isotropic",
    )
    buf, dropped = insert_gaussians(buf, cand, valid, 0.0)
    scene_radius = depth_gt.max() / cfg.scene_radius_depth_ratio
    return buf, dropped, scene_radius


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median as jnp.median takes it: the mean of the two middle values
    of an even count."""
    return torch.quantile(x.reshape(-1), 0.5)


@torch.no_grad()
def densify_phase(
    buf: GaussianBuffer,
    cam: Camera,  # w2c = the current frame
    rgb: torch.Tensor,
    depth_gt: torch.Tensor,
    frame_id: float,
    cfg: MapperConfig,
    mesh=None,
):
    """Silhouette/depth-error densification (add_new_gaussians semantics,
    splatam.py:332-379): pixels the map does not yet explain become new
    Gaussians in free buffer slots, at the densification resolution
    (cfg.densify_downscale_factor). The silhouette comes from an exact
    render (B3 over CSR runs, forward only): a k-truncated silhouette reads
    falsely low on dense tiles and re-adds present surfaces every map frame.
    With `mesh` and k_per_tile > 0 the silhouette render shards its rows
    over the mesh (parallel/sharded.render_sharded_tiled, the multi-pass
    walk over ceil(N/k) windows, exact as well). Returns (buf,
    num_dropped, num_inserted)."""
    f = max(int(cfg.densify_downscale_factor), 1)
    if f > 1:
        cam = cam.replace(
            width=cam.width // f, height=cam.height // f,
            fx=cam.fx / f, fy=cam.fy / f, cx=cam.cx / f, cy=cam.cy / f,
        )
        rgb = rgb[::f, ::f][: cam.height, : cam.width]
        depth_gt = depth_gt[::f, ::f][: cam.height, : cam.width]
    if mesh is not None and cfg.k_per_tile > 0:
        from activesplat_tpu_torch.parallel.sharded import render_sharded_tiled

        _, out_depth, sil, _, _ = render_sharded_tiled(buf, cam, mesh, k_per_tile=cfg.k_per_tile,
                                                       exact=True)
        out_depth, sil = out_depth.to(buf.device), sil.to(buf.device)
    else:
        out = render(buf, cam, chunk=cfg.chunk, k_per_tile=cfg.k_per_tile,
                     exact=cfg.k_per_tile > 0)
        sil, out_depth = out.alpha, out.depth
    depth_error = torch.abs(depth_gt - out_depth) * (depth_gt > 0)
    non_presence_depth = (
        (out_depth > depth_gt)
        & (depth_error > 2.0 * _median(depth_error))
        & (sil > cfg.sil_thres)
        & (depth_gt < cfg.new_gaussian_depth_limit)
    )
    non_presence = (sil < cfg.sil_thres) | non_presence_depth
    valid = non_presence.reshape(-1) & (depth_gt.reshape(-1) > 0)
    cand, cand_valid = gaussians_from_rgbd(
        rgb, depth_gt, cam.fx, cam.fy, cam.cx, cam.cy, torch.linalg.inv(cam.w2c),
        isotropic=cfg.gaussian_distribution == "isotropic",
    )
    before = buf.num_active()
    buf, dropped = insert_gaussians(buf, cand, valid & cand_valid, frame_id)
    return buf, dropped, buf.num_active() - before


@torch.no_grad()
def clone_split(buf: GaussianBuffer, scene_radius: float, frame_id: float, noise: torch.Tensor,
                cfg: MapperConfig):
    """densify_gradient_phase given its (C, 3) standard normal draws."""
    avg_grad = buf.grad_accum / torch.clamp(buf.denom, min=1.0)
    high = buf.active & (avg_grad > cfg.densify_grad_thresh)
    p = buf.params
    big = torch.exp(p.log_scales).amax(dim=-1) > cfg.densify_percent_dense * scene_radius
    clone_mask = high & ~big
    split_mask = (high & big)[:, None]
    shrink = float(np.log(np.float32(1.6)))  # jnp.log(1.6): a float32 log
    cand = p.replace(
        means3d=torch.where(split_mask, p.means3d + noise * torch.exp(p.log_scales), p.means3d),
        log_scales=torch.where(split_mask, p.log_scales - shrink, p.log_scales),
    )
    before = buf.num_active()
    buf, dropped = insert_gaussians(buf, cand, clone_mask | split_mask[:, 0], frame_id)
    # shrink the split originals (their inserted copies already are)
    p = buf.params
    buf = buf.replace(
        params=p.replace(log_scales=torch.where(split_mask, p.log_scales - shrink, p.log_scales))
    )
    return buf, dropped, buf.num_active() - before


def densify_gradient_phase(
    buf: GaussianBuffer,
    scene_radius: float,
    frame_id: float,
    generator: torch.Generator,
    cfg: MapperConfig,
):
    """Gradient-driven clone/split (densify, slam_external.py:195-247): small
    high-gradient Gaussians are cloned; big ones are split, a perturbed copy
    inserted and the original's scale shrunk by 1.6. The perturbation's
    normal draws come from `generator` (on the buffer's device), so they
    differ from jax.random's. Returns (buf, num_dropped, num_new)."""
    noise = torch.randn(
        buf.params.means3d.shape, generator=generator, device=buf.device, dtype=torch.float32
    )
    return clone_split(buf, scene_radius, frame_id, noise, cfg)


@torch.no_grad()
def _prune_removal(buf: GaussianBuffer, scene_radius, opacity_threshold: float, remove_big: bool):
    opac = torch.sigmoid(buf.params.logit_opacities)
    remove = buf.active & (opac < opacity_threshold)
    if remove_big:
        big = torch.exp(buf.params.log_scales).amax(dim=-1) > 0.1 * scene_radius
        remove = remove | (buf.active & big)
    return prune_mask(buf, remove), remove.sum(dtype=torch.int32)


@torch.no_grad()
def _reset_opacities(buf: GaussianBuffer) -> GaussianBuffer:
    """Reset every active Gaussian's opacity to 0.01 (inverse-sigmoid logit;
    slam_external.py:188-190)."""
    p = buf.params
    new_logit = torch.full_like(p.logit_opacities, float(np.log(0.01 / (1.0 - 0.01))))
    return buf.replace(
        params=p.replace(
            logit_opacities=torch.where(buf.active, new_logit, p.logit_opacities)
        )
    )


@stage("mapper/prune")
def prune_phase(
    buf: GaussianBuffer,
    cfg: MapperConfig,
    iteration: int = 0,
    scene_radius: float = float("inf"),
):
    """prune_gaussians parity (slam_external.py:171-192): schedule-gated
    low-opacity removal, too-big-vs-scene-radius removal after
    remove_big_after, and periodic opacity reset. Returns (buf, n_removed)."""
    pd = cfg.prune
    n_removed = torch.zeros((), dtype=torch.int32, device=buf.device)
    if pd.removal_fires(iteration):
        thresh = (
            pd.final_removal_opacity_threshold
            if iteration == pd.stop_after
            else pd.removal_opacity_threshold
        )
        buf, n_removed = _prune_removal(
            buf, scene_radius, float(thresh),
            iteration >= pd.remove_big_after,
        )
    if pd.reset_fires(iteration):
        buf = _reset_opacities(buf)
    return buf, n_removed
