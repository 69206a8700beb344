"""Per-group Adam on the Gaussian buffer (counterpart of
activesplat_tpu/mapper/adam.py).

The reference's optimizer semantics (initialize_optimizer, splatam.py:118-124:
torch.optim.Adam with one LR per param group, eps=1e-15, bias-corrected),
re-created fresh at each mapping event (splatam/__init__.py:440), so the state
never needs surgery when Gaussians are added or removed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from activesplat_tpu_torch.models.gaussians import GaussianParams


@dataclasses.dataclass
class AdamState:
    count: int
    mu: GaussianParams
    nu: GaussianParams

    @staticmethod
    def init(params: GaussianParams) -> "AdamState":
        return AdamState(
            count=0,
            mu=params.map(lambda p: torch.zeros_like(p.detach())),
            nu=params.map(lambda p: torch.zeros_like(p.detach())),
        )


@torch.no_grad()
def adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: GaussianParams,  # float leaves: per-group learning rates
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One bias-corrected Adam step. Returns (new_params, new_state)."""
    count = state.count + 1
    # bias corrections in float32, as the reference computes them
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))

    mu = state.mu.map(lambda m, g: b1 * m + (1.0 - b1) * g, grads)
    nu = state.nu.map(lambda v, g: b2 * v + (1.0 - b2) * g * g, grads)

    def step(p, m, v, lr):
        return p.detach() - lr * (m / c1) / (torch.sqrt(v / c2) + eps)

    new_params = params.map(step, mu, nu, lrs)
    return new_params, AdamState(count=count, mu=mu, nu=nu)


def lr_params(cfg) -> GaussianParams:
    """Per-group learning rates from a MapperConfig (lr_pytree in the JAX
    package)."""
    return GaussianParams(*cfg.lr_tuple())
