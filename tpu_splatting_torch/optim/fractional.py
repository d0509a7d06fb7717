"""Fractional (visibility-weighted) sparse optimizers — plain torch.

Counterpart of ``tpu_splatting/optim/fractional.py``.  The updates are
per-point elementwise math, so there is no kernel: the reference has no
Pallas kernel here either.

EMA decays are raised to the power of the per-point visibility weight
``w`` (``lerp(beta**w, state, new)``), bias correction uses the
accumulated ``total_weight`` and the applied step is scaled by
``saturate(w) = 1 - exp(-2w)``.  The step is dense over all N points with
``weight = 0`` for invisible points, which leaves their state and
parameters untouched.

Like the reference, ``step`` is functional: it returns new parameter
tensors and a new state and modifies neither its arguments nor their
storage (a trainer that wants to save memory may assign the results back
in place itself).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from .. import trace


def lerp(t, a, b):
  """a * t + b * (1 - t)."""
  return a * t + b * (1.0 - t)


def saturate(x):
  """1 - exp(-2x)."""
  return 1.0 - torch.exp(-2.0 * x)


def power_lerp(t, a, b, k=2):
  """lerp on k-th powers."""
  return (a ** k + (b ** k - a ** k) * t) ** (1.0 / k)


@dataclass(frozen=True)
class GroupConfig:
  """Per-parameter-group hyperparameters."""
  type: str = "scalar"            # "scalar" | "vector" | "local_vector"
  lr: float = 0.001
  betas: Tuple[float, float] = (0.9, 0.999)
  eps: float = 1e-16
  bias_correction: bool = True
  clip: Optional[float] = None
  # extra hyperparameters (ignored by the step; kept for trainers)
  extra: Dict[str, float] = field(default_factory=dict)

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


def init_group_state(param: torch.Tensor, cfg: GroupConfig):
  """m/v state rows: vector types keep a scalar v (running grad norm)."""
  p2 = param.reshape(param.shape[0], -1)
  if cfg.type == "scalar":
    return {"m": torch.zeros_like(p2), "v": torch.zeros_like(p2)}
  return {"m": torch.zeros_like(p2), "v": p2.new_zeros((p2.shape[0],))}


def _bias_adam(total_weight, betas):
  b1, b2 = betas
  tw = torch.clamp(total_weight, min=1e-12)
  return torch.sqrt(1.0 - b2 ** tw) / (1.0 - b1 ** tw + 1e-30)


def adam_update(cfg: GroupConfig, state, grad, weight, total_weight):
  """Fractional Adam: (lr_step (N, D), new_state)."""
  b1, b2 = cfg.betas
  w = weight[:, None]
  bias = (_bias_adam(total_weight, cfg.betas) if cfg.bias_correction
          else torch.ones_like(total_weight))
  m = lerp(b1 ** w, state["m"], grad)
  if cfg.type == "scalar":
    v = lerp(b2 ** w, state["v"], grad * grad)
    denom = torch.clamp(torch.sqrt(v), min=cfg.eps)
  else:
    v = lerp(b2 ** weight, state["v"], torch.sum(grad * grad, -1))
    denom = torch.clamp(torch.sqrt(v), min=cfg.eps)[:, None]
  return m / denom * bias[:, None] * cfg.lr, {"m": m, "v": v}


def laprop_update(cfg: GroupConfig, state, grad, weight, total_weight):
  """Fractional LaProp: normalise the gradient by the bias-corrected
  second moment before the momentum average."""
  b1, b2 = cfg.betas
  w = weight[:, None]
  tw = torch.clamp(total_weight, min=1e-12)
  if cfg.bias_correction:
    bias1 = (1.0 - b1 ** tw)[:, None]
    bias2 = 1.0 - b2 ** tw
  else:
    bias1 = grad.new_ones((grad.shape[0], 1))
    bias2 = grad.new_ones((grad.shape[0],))
  if cfg.type == "scalar":
    v = lerp(b2 ** w, state["v"], grad * grad)
    g_norm = grad / torch.clamp(torch.sqrt(v / bias2[:, None]), min=cfg.eps)
  else:
    v = lerp(b2 ** weight, state["v"], torch.sum(grad * grad, -1))
    g_norm = grad / torch.clamp(torch.sqrt(v / bias2), min=cfg.eps)[:, None]
  m = lerp(b1 ** w, state["m"], g_norm)
  return m * cfg.lr / bias1, {"m": m, "v": v}


_UPDATES = {"adam": adam_update, "laprop": laprop_update}


def weighted_step(kind: str, cfg: GroupConfig, state, grad, weight,
                  total_weight, basis: Optional[torch.Tensor] = None,
                  mask_lr: Optional[torch.Tensor] = None,
                  point_lr: Optional[torch.Tensor] = None):
  """One fractional update of a group: (step shaped like grad, state).

  Dense over N points; ``weight`` is 0 for invisible points (their state
  is untouched and their step is 0)."""
  shape = grad.shape
  grad = grad.reshape(shape[0], -1)
  active = weight > 0

  if cfg.type == "local_vector":
    assert basis is not None, "basis is required for local_vector optimizer"
    grad = torch.einsum("bij,bj->bi", torch.linalg.inv(basis), grad)

  lr_step, new_state = _UPDATES[kind](cfg, state, grad, weight, total_weight)

  if cfg.clip is not None:
    max_step = cfg.lr * cfg.clip
    lr_step = torch.clamp(lr_step, -max_step, max_step)
  if cfg.type == "local_vector":
    lr_step = torch.einsum("bij,bj->bi", basis, lr_step)
  if mask_lr is not None:
    lr_step = lr_step * mask_lr.reshape(1, -1)
  if point_lr is not None:
    lr_step = lr_step * point_lr[:, None]

  lr_step = torch.where(torch.isfinite(lr_step), lr_step, 0.0)
  lr_step = torch.where(active[:, None], lr_step, 0.0)
  # freeze the state rows of invisible points (beta**0 == 1 already
  # implies it for the EMAs; enforce it against float error)
  new_state = {
      k: torch.where(active.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                     state[k])
      for k, x in new_state.items()}
  step = lr_step * saturate(weight)[:, None]
  return step.reshape(shape), new_state


@dataclass
class FractionalState:
  groups: Dict[str, dict]
  total_weight: torch.Tensor
  running_vis: torch.Tensor


class FractionalOpt:
  """Fractional optimizer over a dict of parameter tensors.

  ``state = opt.init(params)``;
  ``params, state = opt.step(params, grads, state, weight, basis=...)``.
  """

  kind = "adam"

  def __init__(self, groups: Dict[str, GroupConfig]):
    self.groups = groups

  def init(self, params: Dict[str, torch.Tensor]) -> FractionalState:
    first = next(iter(params.values()))
    n = first.shape[0]
    return FractionalState(
        groups={k: init_group_state(params[k], cfg)
                for k, cfg in self.groups.items()},
        total_weight=first.new_zeros((n,)),
        running_vis=first.new_zeros((n,)))

  def step(self, params, grads, state: FractionalState,
           weight: torch.Tensor, basis: Optional[torch.Tensor] = None,
           mask_lr: Optional[Dict[str, torch.Tensor]] = None,
           point_lr: Optional[Dict[str, torch.Tensor]] = None):
    total_weight = state.total_weight + weight
    new_params = dict(params)
    new_groups = dict(state.groups)
    for name, cfg in self.groups.items():
      if grads.get(name) is None:
        continue
      step, gstate = weighted_step(
          self.kind, cfg, state.groups[name], grads[name], weight,
          total_weight, basis=basis,
          mask_lr=None if mask_lr is None else mask_lr.get(name),
          point_lr=None if point_lr is None else point_lr.get(name))
      new_params[name] = params[name] - step
      new_groups[name] = gstate
    return new_params, FractionalState(
        groups=new_groups, total_weight=total_weight,
        running_vis=state.running_vis)


class FractionalAdam(FractionalOpt):
  kind = "adam"


class FractionalLaProp(FractionalOpt):
  kind = "laprop"


class SparseAdam(FractionalAdam):
  """weight == 1 for every visible point."""

  def step(self, params, grads, state, visible_mask, **kw):
    weight = visible_mask.to(state.total_weight.dtype)
    return super().step(params, grads, state, weight, **kw)


class SparseLaProp(FractionalLaProp):
  def step(self, params, grads, state, visible_mask, **kw):
    weight = visible_mask.to(state.total_weight.dtype)
    return super().step(params, grads, state, weight, **kw)


class VisibilityOptimizer(FractionalOpt):
  """Visibility-aware variant: keeps a running visibility EMA (power-lerp,
  k=4), weights steps by visibility / running visibility and normalises
  the gradients by the visibility."""

  def __init__(self, groups: Dict[str, GroupConfig], vis_beta: float = 0.5,
               vis_smooth: float = 0.01):
    super().__init__(groups)
    self.vis_beta = vis_beta
    self.vis_smooth = vis_smooth

  def step(self, params, grads, state: FractionalState,
           visibility: torch.Tensor, basis: Optional[torch.Tensor] = None,
           **kw):
    with trace.span("optimizer"):
      visible = visibility > 0
      updated_vis = power_lerp(self.vis_beta, visibility, state.running_vis,
                               k=4)
      updated_vis = torch.where(visible, updated_vis, state.running_vis)
      weight = torch.where(
          visible, visibility / torch.clamp(updated_vis, min=1e-12), 0.0)
      norm_grads = {
          k: g / (visibility + self.vis_smooth).reshape(
              (-1,) + (1,) * (g.dim() - 1))
          for k, g in grads.items() if g is not None}
      new_params, new_state = super().step(
          params, norm_grads, state, weight, basis=basis, **kw)
      return new_params, dataclasses.replace(new_state,
                                             running_vis=updated_vis)


class VisibilityAwareAdam(VisibilityOptimizer):
  kind = "adam"


class VisibilityAwareLaProp(VisibilityOptimizer):
  kind = "laprop"
