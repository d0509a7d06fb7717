"""ParameterClass: parameters with row-synchronised optimizer state.

Counterpart of ``tpu_splatting/optim/parameter_class.py``: a dict of
parameter (and non-parameter) tensors whose optimizer state stays
row-aligned under point edits (boolean or index filtering, appending, for
split/prune training), plus checkpointing.

Functional, as the reference and the port's ``FractionalOpt.step`` are:
every method returns a new ``ParameterClass`` and modifies neither its
tensors nor their storage.  Point-count edits change the tensors' shapes
and happen between training steps.
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import fractional
from .fractional import FractionalOpt, FractionalState, GroupConfig


def map_state(fn: Callable, *states: FractionalState) -> FractionalState:
  """A FractionalState of ``fn`` applied leaf by leaf to the tensors of
  ``states`` (every group's moments, total_weight, running_vis)."""
  first = states[0]
  groups = {name: {k: fn(*(s.groups[name][k] for s in states))
                   for k in g} for name, g in first.groups.items()}
  return FractionalState(
      groups=groups,
      total_weight=fn(*(s.total_weight for s in states)),
      running_vis=fn(*(s.running_vis for s in states)))


@dataclass
class ParameterClass:
  """Tensors + optimizer + row-synchronised optimizer state."""
  tensors: Dict[str, torch.Tensor]
  optimizer: FractionalOpt
  opt_state: FractionalState

  @staticmethod
  def create(tensors: Dict[str, torch.Tensor],
             parameter_groups: Dict[str, GroupConfig],
             optimizer_cls=None, opt_state: Optional[FractionalState] = None,
             **optim_kwargs) -> "ParameterClass":
    optimizer_cls = optimizer_cls or fractional.VisibilityAwareLaProp
    for k in parameter_groups:
      assert k in tensors, f"group {k} not in tensors {list(tensors)}"
    optimizer = optimizer_cls(parameter_groups, **optim_kwargs)
    if opt_state is None:
      opt_state = optimizer.init(tensors)
    return ParameterClass(dict(tensors), optimizer, opt_state)

  # attribute access to tensors
  def __getattr__(self, name):
    tensors = object.__getattribute__(self, "tensors")
    if name in tensors:
      return tensors[name]
    raise AttributeError(name)

  def keys(self):
    return self.tensors.keys()

  def items(self):
    return self.tensors.items()

  def optimized_keys(self):
    return self.optimizer.groups.keys()

  @property
  def parameter_groups(self) -> Dict[str, GroupConfig]:
    return self.optimizer.groups

  @property
  def batch_size(self):
    return (next(iter(self.tensors.values())).shape[0],)

  def __len__(self):
    return self.batch_size[0]

  # learning rates
  def set_learning_rate(self, **rates: float) -> "ParameterClass":
    groups = {k: (cfg.replace(lr=rates[k]) if k in rates else cfg)
              for k, cfg in self.optimizer.groups.items()}
    opt = type(self.optimizer)(groups, **self._opt_kwargs())
    return dataclasses.replace(self, optimizer=opt)

  @property
  def learning_rates(self) -> Dict[str, float]:
    return {k: cfg.lr for k, cfg in self.optimizer.groups.items()}

  def _opt_kwargs(self):
    kw = {}
    if hasattr(self.optimizer, "vis_beta"):
      kw["vis_beta"] = self.optimizer.vis_beta
      kw["vis_smooth"] = self.optimizer.vis_smooth
    return kw

  # optimizer step (delegates; functional)
  def step(self, grads: Dict[str, torch.Tensor], *args,
           **kw) -> "ParameterClass":
    new_tensors, new_state = self.optimizer.step(
        self.tensors, grads, self.opt_state, *args, **kw)
    return dataclasses.replace(self, tensors=new_tensors,
                               opt_state=new_state)

  # row surgery, between steps
  def __getitem__(self, idx):
    """A tensor by name, or the rows ``idx`` (a bool mask or indices) of
    every tensor and of the optimizer state."""
    if isinstance(idx, str):
      return self.tensors[idx]
    first = next(iter(self.tensors.values()))
    idx = torch.as_tensor(idx, device=first.device)
    if idx.dtype == torch.bool:
      idx = torch.nonzero(idx).reshape(-1)
    tensors = {k: v[idx] for k, v in self.tensors.items()}
    opt_state = map_state(lambda x: x[idx], self.opt_state)
    return dataclasses.replace(self, tensors=tensors, opt_state=opt_state)

  def append_tensors(self, tensors: Dict[str, torch.Tensor],
                     tensor_state: Optional[FractionalState] = None
                     ) -> "ParameterClass":
    """Concatenate new rows with zeroed (or the given) optimizer state."""
    assert set(tensors.keys()) == set(self.tensors.keys()), (
        f"{set(tensors.keys())} != {set(self.tensors.keys())}")
    n_new = next(iter(tensors.values())).shape[0]
    if tensor_state is None:
      tensor_state = map_state(
          lambda x: x.new_zeros((n_new, *x.shape[1:])), self.opt_state)
    merged = {k: torch.cat([self.tensors[k], tensors[k]])
              for k in self.tensors}
    opt_state = map_state(lambda a, b: torch.cat([a, b]), self.opt_state,
                          tensor_state)
    return dataclasses.replace(self, tensors=merged, opt_state=opt_state)

  def append(self, other: "ParameterClass") -> "ParameterClass":
    return self.append_tensors(other.tensors, other.opt_state)

  # checkpointing
  def state_dict(self) -> dict:
    def to_numpy(x):
      return x.detach().cpu().numpy()
    return {
        "tensors": {k: to_numpy(v) for k, v in self.tensors.items()},
        "opt_state": map_state(to_numpy, self.opt_state),
        "parameter_groups": self.optimizer.groups,
        "optimizer_cls": type(self.optimizer).__name__,
        "optim_kwargs": self._opt_kwargs(),
    }

  @staticmethod
  def from_state_dict(state: dict, device="cuda") -> "ParameterClass":
    """The ParameterClass of a ``state_dict``, its tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    cls = getattr(fractional, state["optimizer_cls"])

    def to_tensor(x):
      return torch.as_tensor(np.asarray(x), device=device)
    tensors = {k: to_tensor(v) for k, v in state["tensors"].items()}
    return ParameterClass.create(
        tensors, state["parameter_groups"], optimizer_cls=cls,
        opt_state=map_state(to_tensor, state["opt_state"]),
        **state["optim_kwargs"])

  def save(self, path: str):
    with open(path, "wb") as f:
      pickle.dump(self.state_dict(), f)

  @staticmethod
  def load(path: str, device="cuda") -> "ParameterClass":
    """A checkpoint written by ``save`` (unpickled: load only files this
    program wrote)."""
    with open(path, "rb") as f:
      return ParameterClass.from_state_dict(pickle.load(f), device)
