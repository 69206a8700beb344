"""Copies of the timed path's inputs and outputs, taken while the window runs,
for the reference to judge once it has closed.

The hooks wrap the program's own functions at the module attributes through
which the program calls them, and copy (on the device, with no host sync)
only the calls sampled from the seed: the i-th call of a kind counted from
the window's start. Kinds:

- "iteration": `mapper.step.loss_and_grads` and `mapper.step._step`, the
  mapping iteration's loss and gradients and its Adam step;
- "densify": `mapper.splatam.densify_phase`, with the pixels it chose as
  they reach `insert_gaussians`;
- "topdown": `queries.topdown.IncrementalTopdown.refresh`, the maps the
  planner reads;
- "panorama": `queries.panorama._render_views_quantized`, the views behind
  the planner's invisibility scores.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

import numpy as np
import torch

LEAVES = ("means3d", "rgb", "quats", "logit_opacities", "log_scales")


def _params(p) -> Dict[str, torch.Tensor]:
    return {k: getattr(p, k).detach().clone() for k in LEAVES}


def _cfg(cfg) -> Dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name not in ("lrs", "prune")}
    d["lrs"] = dict(zip(LEAVES, cfg.lr_tuple()))
    return d


class Captures:
    def __init__(self, plan: Dict[str, Set[int]], intrinsics: Dict) -> None:
        self.plan = plan
        self.intrinsics = intrinsics  # the mapper's camera, from the configuration
        self.open = False
        self.calls = {k: 0 for k in plan}
        self.taken: Dict[str, List[Dict]] = {k: [] for k in plan}
        self._pending = None
        self._undo = []

    def _take(self, kind: str) -> bool:
        if not self.open or kind not in self.plan:
            return False
        i = self.calls[kind]
        self.calls[kind] += 1
        return i in self.plan[kind]

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def install(self) -> None:
        from activesplat_tpu_torch.mapper import splatam, step
        from activesplat_tpu_torch.queries import panorama, topdown

        me = self
        orig_lag, orig_step = step.loss_and_grads, step._step

        def loss_and_grads(buf, cam, im_gt, depth_gt, cfg, mesh=None):
            take = me._take("iteration")
            if take:
                pre, active = _params(buf.params), buf.active.clone()
                im, dep, w2c = im_gt.detach().clone(), depth_gt.detach().clone(), cam.w2c.clone()
            loss, aux, grads = orig_lag(buf, cam, im_gt, depth_gt, cfg, mesh=mesh)
            if take:
                me._pending = {"pre": pre, "active": active, "im": im, "depth": dep,
                               "cam": dict(me.intrinsics, w2c=w2c), "cfg": _cfg(cfg),
                               "loss": loss.detach().clone(), "grads": _params(grads)}
            return loss, aux, grads

        def _step(buf, opt_state, grads, aux, cfg):
            pend, me._pending = me._pending, None
            if pend is not None:
                pend["adam"] = {"count": opt_state.count, "mu": _params(opt_state.mu),
                                "nu": _params(opt_state.nu)}
            out = orig_step(buf, opt_state, grads, aux, cfg)
            if pend is not None:
                pend["post"] = _params(out[0].params)
                me.taken["iteration"].append(pend)
            return out

        self._patch(step, "loss_and_grads", loss_and_grads)
        self._patch(step, "_step", _step)

        orig_densify = splatam.densify_phase

        def densify_phase(buf, cam, rgb, depth_gt, frame_id, cfg, mesh=None):
            take = me._take("densify")
            if not take:
                return orig_densify(buf, cam, rgb, depth_gt, frame_id, cfg, mesh)
            pre, active = _params(buf.params), buf.active.clone()
            dep, w2c = depth_gt.detach().clone(), cam.w2c.clone()
            chosen = []
            orig_insert = step.insert_gaussians

            def insert_gaussians(buf_, cand, valid, frame_id_):
                # the pixels the densification turns into Gaussians
                chosen.append(valid.detach().clone())
                return orig_insert(buf_, cand, valid, frame_id_)

            step.insert_gaussians = insert_gaussians
            try:
                out = orig_densify(buf, cam, rgb, depth_gt, frame_id, cfg, mesh)
            finally:
                step.insert_gaussians = orig_insert
            me.taken["densify"].append({
                "pre": pre, "active": active, "depth": dep,
                "cam": dict(me.intrinsics, w2c=w2c), "cfg": _cfg(cfg),
                "chosen": chosen[0].reshape(dep.shape)})
            return out

        self._patch(splatam, "densify_phase", densify_phase)

        orig_refresh = topdown.IncrementalTopdown.refresh

        def refresh(inst, buf, foot_adjust: float = 0.0):
            maps = orig_refresh(inst, buf, foot_adjust)
            if me._take("topdown"):
                c = inst.cfg
                me.taken["topdown"].append({
                    "pre": _params(buf.params), "active": buf.active.clone(),
                    "free": np.array(maps[0]), "unobserved": np.array(maps[1]),
                    "topdown_cfg": {"height_axis": c.height_axis,
                                    "world_dim_index": tuple(c.world_dim_index),
                                    "world_center": tuple(c.world_center),
                                    "meter_per_pixel": c.meter_per_pixel,
                                    "grid_shape": tuple(c.grid_shape),
                                    "foot": c.agent_foot + foot_adjust,
                                    "agent_head": c.agent_head}})
            return maps

        self._patch(topdown.IncrementalTopdown, "refresh", refresh)

        orig_views = panorama._render_views_quantized

        def _render_views_quantized(buf, poses, chunk, scale, mesh=None):
            out = orig_views(buf, poses, chunk, scale, mesh)
            if me._take("panorama"):
                me.taken["panorama"].append({
                    "pre": _params(buf.params), "active": buf.active.clone(),
                    "c2ws": np.array(poses), "scale": float(scale),
                    "alpha_u8": out[1].detach().clone()})
            return out

        self._patch(panorama, "_render_views_quantized", _render_views_quantized)

    def finalized(self) -> Dict[str, List[Dict]]:
        """The captures with their device scalars read (after the window)."""
        for cap in self.taken["iteration"] if "iteration" in self.taken else []:
            cap["loss"] = float(cap["loss"])
        return {k: v for k, v in self.taken.items() if v}


def sample_plan(seed: int, spec: Dict[str, Dict]) -> Dict[str, Set[int]]:
    """Which call of each kind to copy, drawn from the seed: `count` distinct
    call indices below `within`, counted from the window's start."""
    rng = np.random.default_rng([int(seed), 1])
    plan = {}
    for kind, s in sorted(spec.items()):
        within, count = int(s["within"]), int(s["count"])
        plan[kind] = set(int(i) for i in rng.choice(within, size=min(count, within),
                                                    replace=False))
    return plan
