"""Faults planted in the program under the capture hooks, for the tests that
drive a whole run and see `correct` come out false (benchmark/test_benchmark.py)."""

from __future__ import annotations

import numpy as np


class Fault:
    def __init__(self) -> None:
        self._undo = []

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


class UnchangedStep(Fault):
    """The mapping step returns the Gaussian table unchanged."""

    def install(self) -> None:
        from activesplat_tpu_torch.mapper import step

        orig = step._step

        def _step(buf, opt_state, grads, aux, cfg):
            return buf, orig(buf, opt_state, grads, aux, cfg)[1]

        self._patch(step, "_step", _step)


class HalfBatch(Fault):
    """The mapping loss over the top half of the frame's rows, the mean taken
    over them."""

    def install(self) -> None:
        from activesplat_tpu_torch.mapper import step

        orig = step.loss_from_render

        def loss_from_render(rgb, depth, alpha, radii, dropped, im_gt, depth_gt, cfg):
            h = rgb.shape[0] // 2
            return orig(rgb[:h], depth[:h], alpha[:h], radii, dropped, im_gt[:h], depth_gt[:h],
                        cfg)

        self._patch(step, "loss_from_render", loss_from_render)


class AlteredGradient(Fault):
    """The colour gradient doubled where the backward makes it."""

    def install(self) -> None:
        from activesplat_tpu_torch.mapper import step

        orig = step.loss_and_grads

        def loss_and_grads(*a, **k):
            loss, aux, grads = orig(*a, **k)
            return loss, aux, grads.replace(rgb=2.0 * grads.rgb)

        self._patch(step, "loss_and_grads", loss_and_grads)


class AlteredTopdown(Fault):
    """One 16x16 tile of the top-down free map flipped where it is made."""

    def install(self) -> None:
        from activesplat_tpu_torch.queries import topdown

        orig = topdown.IncrementalTopdown.refresh

        def refresh(inst, buf, foot_adjust=0.0):
            free, unobs = orig(inst, buf, foot_adjust)
            free = np.array(free)
            free[:16, :16] = 1 - free[:16, :16]
            return free, unobs

        self._patch(topdown.IncrementalTopdown, "refresh", refresh)


class AlteredDensify(Fault):
    """The densification's silhouette inverted over one 16x16 tile, where its
    render makes it: the pixels chosen there change, not only their count."""

    def install(self) -> None:
        from activesplat_tpu_torch.mapper import splatam, step

        orig = splatam.densify_phase

        def densify_phase(*a, **k):
            orig_render = step.render

            def render(*ra, **rk):
                out = orig_render(*ra, **rk)
                alpha = out.alpha.clone()
                alpha[:16, :16] = 1.0 - alpha[:16, :16]
                return out._replace(alpha=alpha)

            step.render = render
            try:
                return orig(*a, **k)
            finally:
                step.render = orig_render

        self._patch(splatam, "densify_phase", densify_phase)


FAULTS = {"unchanged_step": UnchangedStep, "half_batch": HalfBatch,
          "altered_gradient": AlteredGradient, "altered_topdown": AlteredTopdown,
          "altered_densify": AlteredDensify}
