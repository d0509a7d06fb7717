"""Differentiable feature gather and segmented sort.

Counterpart of ``tpu_splatting/misc/indexing.py``.  ``index_features`` is
a gather whose gradient autograd scatter-adds back to the source rows;
``segmented_sort_pairs`` is two stable sorts, by key and then by segment,
which give the reference's two-key ``lax.sort`` order: both order NaN last
and keep -0.0 and 0.0 as equal keys, in their input order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def index_features(features: torch.Tensor, indexes: torch.Tensor
                   ) -> torch.Tensor:
  """Differentiable gather of feature rows; the gradient scatter-adds
  cotangents back to the source rows (duplicates summed)."""
  return torch.index_select(features, 0, indexes)


def segmented_sort_pairs(keys: torch.Tensor, values: torch.Tensor,
                         segments: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Sort (key, value) pairs within segments.

  Args:
    keys, values: (N,) tensors.
    segments: (N,) segment id per element.

  Returns keys and values sorted by (segment, key); segment grouping is
  preserved and ordering within each segment is by key, ties in input
  order.
  """
  by_key = torch.sort(keys, stable=True).indices
  by_segment = torch.sort(segments[by_key], stable=True).indices
  order = by_key[by_segment]
  return keys[order], values[order]
