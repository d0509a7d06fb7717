"""Plain reference of the visibility-aware Adam step on one parameter.

Each point's step is weighted by its visibility against a running
visibility (a power mean, k = 4, of the new visibility and the old
running value at beta 0.5): weight w = vis / running for visible points,
0 otherwise.  The gradient is divided by (vis + 0.01).  Adam's moments
decay by beta ** w, bias correction uses the point's accumulated weight,
and the step is scaled by 1 - exp(-2 w).  Invisible points keep their
parameters and state.
"""

from __future__ import annotations

import torch


class VisibilityAdam:
  def __init__(self, param, lr=1e-3, betas=(0.9, 0.999), eps=1e-16,
               vis_beta=0.5, vis_smooth=0.01):
    n = param.shape[0]
    self.lr, self.betas, self.eps = lr, betas, eps
    self.vis_beta, self.vis_smooth = vis_beta, vis_smooth
    self.m = torch.zeros_like(param.reshape(n, -1))
    self.v = torch.zeros_like(self.m)
    self.total = param.new_zeros(n)
    self.running = param.new_zeros(n)

  def step(self, param, grad, vis):
    """The updated parameter (a new tensor)."""
    b1, b2 = self.betas
    shape = param.shape
    g = grad.reshape(shape[0], -1)
    visible = vis > 0
    mixed = (vis ** 4 + (self.running ** 4 - vis ** 4) * self.vis_beta
             ) ** 0.25
    running = torch.where(visible, mixed, self.running)
    w = torch.where(visible, vis / torch.clamp(running, min=1e-12), 0.0)
    g = g / (vis + self.vis_smooth)[:, None]
    total = self.total + w
    tw = torch.clamp(total, min=1e-12)
    bias = torch.sqrt(1.0 - b2 ** tw) / (1.0 - b1 ** tw + 1e-30)
    d1, d2 = (b1 ** w)[:, None], (b2 ** w)[:, None]
    m = self.m * d1 + g * (1.0 - d1)
    v = self.v * d2 + g * g * (1.0 - d2)
    step = m / torch.clamp(torch.sqrt(v), min=self.eps) * bias[:, None] * \
        self.lr
    step = torch.where(torch.isfinite(step) & visible[:, None], step, 0.0)
    self.m = torch.where(visible[:, None], m, self.m)
    self.v = torch.where(visible[:, None], v, self.v)
    self.total, self.running = total, running
    step = step * (1.0 - torch.exp(-2.0 * w))[:, None]
    return param - step.reshape(shape)
