"""Recursive non-finite guard (debug aid).

Counterpart of ``tpu_splatting/utils/check_finite.py``: counts, or raises
on, non-finite values across nested containers of tensors.  Host-side (it
reads every floating leaf back, a synchronisation on the card): call it
between training steps, as the trainer does with ``--debug``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(tree, path=""):
  """(path, leaf) of every leaf, in the reference's order and with its
  path strings (``jax.tree_util.keystr``): dicts by sorted key as
  ``['key']``, sequences as ``[i]``, NamedTuples and dataclasses by field
  as ``.name``."""
  if tree is None:
    return
  if isinstance(tree, dict):
    for k in sorted(tree):
      yield from _leaves(tree[k], f"{path}[{k!r}]")
  elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
    for name in tree._fields:
      yield from _leaves(getattr(tree, name), f"{path}.{name}")
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _leaves(v, f"{path}[{i}]")
  elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    for f in dataclasses.fields(tree):
      yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
  else:
    yield path, tree


def count_nonfinite(tree) -> dict:
  """{path: count} of non-finite values for every floating leaf (tensor
  or numpy array)."""
  out = {}
  for path, leaf in _leaves(tree):
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
      bad = int((~torch.isfinite(leaf)).sum())
    elif isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                        np.floating):
      bad = int(np.sum(~np.isfinite(leaf)))
    else:
      continue
    if bad:
      out[path] = bad
  return out


def check_finite(tree, name: str = "tree"):
  """Raise ValueError if any floating leaf contains non-finite values."""
  bad = count_nonfinite(tree)
  if bad:
    detail = ", ".join(f"{k}: {v}" for k, v in bad.items())
    raise ValueError(f"non-finite values in {name}: {detail}")
