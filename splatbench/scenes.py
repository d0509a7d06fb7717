"""The benchmark's scenes, poses and targets, made from a seed.

Frozen copies of the scene arithmetic of ``tpu_splatting_torch.scenes``
(``uniform_scene``, ``heavy_scene`` and ``lift_to_3d``): the same
formulas, draw for draw in the same order, so that the program can change
without changing what is measured.  The draws come from a ``Draws``
object: on the card a ``torch.Generator`` seeded with ``--seed`` (a few
large calls, float32, on the device); in the tests a numpy ``Generator``,
which makes these functions reproduce the port's arrays.
"""

from __future__ import annotations

import math

import torch

# 1 / the SH DC basis value (lift_to_3d's colour in the DC term)
SH_C0 = 0.28209479177387814


class Draws:
  """Random draws on ``device`` from ``torch.Generator(seed)``, float32.
  The methods mirror the numpy ``Generator`` calls of the port's scenes:
  ``uniform(lo, hi, shape)`` is ``lo + (hi - lo) * random(shape)``."""

  def __init__(self, seed: int, device):
    self.device = torch.device(device)
    self.gen = torch.Generator(self.device)
    self.gen.manual_seed(int(seed))

  def random(self, shape):
    return torch.rand(shape, generator=self.gen, device=self.device)

  def uniform(self, lo, hi, shape):
    return lo + (hi - lo) * self.random(shape)

  def normal(self, mu, sigma, shape):
    return mu + sigma * torch.randn(shape, generator=self.gen,
                                    device=self.device)

  def integers(self, high, shape):
    return torch.randint(high, shape if isinstance(shape, tuple)
                         else (shape,), generator=self.gen,
                         device=self.device)


def uniform_scene(draws, n: int, image_size):
  """n splats uniform over the image: (packed (n, 7), NDC depth (n,),
  colours (n, 3)), float32 (``scenes.uniform_scene``)."""
  w, h = image_size
  f32 = torch.float32
  density = 1.2 * w / (1 + math.sqrt(n))
  x = draws.uniform(0, w, n)
  y = draws.uniform(0, h, n)
  theta = draws.uniform(0, math.pi, n)
  scale = (draws.random((n, 2)) + 0.2) * density
  opacity = draws.uniform(0.1, 0.9, n)
  packed = torch.stack([x, y, torch.cos(theta), torch.sin(theta),
                        scale[:, 0], scale[:, 1], opacity], -1).to(f32)
  depth = draws.uniform(0.05, 0.95, n).to(f32)
  feats = draws.random((n, 3)).to(f32)
  return packed, depth, feats


def heavy_scene(draws, n: int, image_size):
  """3DGS-checkpoint statistics (``scenes.heavy_scene``): log-normal
  projected scales (median ~1.3 px, tail clipped at 110 px), anisotropy,
  opacity mass near 0 and 1, clustering about 4,096 centres."""
  w, h = image_size
  f32 = torch.float32
  n_c = 4096
  cx = draws.uniform(0, w, n_c)
  cy = draws.uniform(0, h, n_c)
  which = draws.integers(n_c, n)
  jitter = draws.normal(0.0, 0.08, (n, 2))
  px = torch.clamp(cx[which] + jitter[:, 0] * w, 0, w - 1)
  py = torch.clamp(cy[which] + jitter[:, 1] * h, 0, h - 1)
  theta = draws.uniform(0, math.pi, n)
  s_major = torch.exp(draws.normal(0.35, 0.9, n)).to(f32)
  ratio = torch.exp(-torch.abs(draws.normal(0.0, 0.7, n))).to(f32)
  opacity = 1.0 / (1.0 + torch.exp(-draws.normal(0.0, 2.5, n)))
  packed = torch.stack([
      px.to(f32), py.to(f32), torch.cos(theta).to(f32),
      torch.sin(theta).to(f32), torch.clamp(s_major, 0.05, 110.0),
      torch.clamp(s_major * ratio, 0.05, 110.0), opacity.to(f32)], -1)
  depth = draws.uniform(0.02, 0.98, n).to(f32)
  feats = draws.random((n, 3)).to(f32)
  return packed, depth, feats


def lift_to_3d(draws, packed, depth_ndc, feats, image_size, near: float,
               far: float, fov_deg: float):
  """The arithmetic of ``scenes.lift_to_3d``: each splat on the camera ray
  through its 2D position at the metric depth of its NDC depth, in-plane
  scales = pixel scales * z / f, a rotation about the view axis, SH degree
  3 with the colour in the DC term and N(0, 0.02) higher terms (drawn
  from ``draws``).  Returns the five leaves (position, log_scaling,
  rotation, alpha_logit, feature) and (fx, fy, cx, cy)."""
  w, h = image_size
  fx = fy = 0.5 * w / math.tan(0.5 * math.radians(fov_deg))
  cx, cy = w / 2.0, h / 2.0
  z = 1.0 / (1.0 / near + depth_ndc * (1.0 / far - 1.0 / near))
  x3 = (packed[:, 0] - cx) * z / fx
  y3 = (packed[:, 1] - cy) * z / fy
  s3 = packed[:, 4:6] * (z / fx)[:, None]
  log_scaling = torch.log(torch.cat(
      [s3, torch.minimum(s3[:, :1], s3[:, 1:])], -1))
  theta = torch.atan2(packed[:, 3], packed[:, 2])
  zero = torch.zeros_like(theta)
  rotation = torch.stack([zero, zero, torch.sin(0.5 * theta),
                          torch.cos(0.5 * theta)], -1)
  a = torch.clamp(packed[:, 6], 1e-4, 1 - 1e-4)
  alpha_logit = torch.log(a / (1 - a))[:, None]
  n = packed.shape[0]
  higher = draws.normal(0.0, 0.02, (n, 3, 15)).to(packed.dtype)
  feature = torch.cat([(feats / SH_C0)[:, :, None], higher], -1)
  leaves = (torch.stack([x3, y3, z], -1), log_scaling, rotation,
            alpha_logit, feature)
  return leaves, (fx, fy, cx, cy)


def poses(draws, count: int, shift: float, roll_deg: float):
  """``count`` world-to-camera (4, 4) float32 matrices: a roll about the
  optical axis of up to +-roll_deg and a translation of up to +-shift per
  axis, uniform."""
  t = draws.uniform(-shift, shift, (count, 3))
  ang = torch.deg2rad(draws.uniform(-roll_deg, roll_deg, count))
  m = torch.zeros((count, 4, 4), dtype=torch.float32, device=t.device)
  c, s = torch.cos(ang), torch.sin(ang)
  m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
  m[:, 2, 2] = m[:, 3, 3] = 1.0
  m[:, :3, 3] = t
  return list(m)


def shifts(draws, count: int, shift_px: float):
  """``count`` (dx, dy) offsets in pixels, uniform in +-shift_px."""
  return list(draws.uniform(-shift_px, shift_px, (count, 2)))


def target(draws, image_size, tile_size: int):
  """A (T, 3, tile_size**2) uniform target in the renderer's tiled layout,
  zero outside the image, and its (T, 1, tile_size**2) mask."""
  w, h = image_size
  img = draws.random((h, w, 3))
  mask = torch.ones((h, w, 1), dtype=img.dtype, device=img.device)
  return entile(img, tile_size), entile(mask, tile_size)


def entile(image, tile_size: int):
  """(H, W, C) -> (tiles, C, tile_size**2), row-major tiles, pixels
  row-major within a tile, zero-padded to whole tiles."""
  h, w, c = image.shape
  th, tw = -(-h // tile_size), -(-w // tile_size)
  img = torch.nn.functional.pad(
      image, (0, 0, 0, tw * tile_size - w, 0, th * tile_size - h))
  t = img.reshape(th, tile_size, tw, tile_size, c)
  return t.permute(0, 2, 4, 1, 3).reshape(th * tw, c, tile_size * tile_size)


def detile(tiled, image_size, tile_size: int):
  """(tiles, C, tile_size**2) -> (H, W, C)."""
  w, h = image_size
  th, tw = -(-h // tile_size), -(-w // tile_size)
  c = tiled.shape[1]
  t = tiled.reshape(th, tw, c, tile_size, tile_size)
  return t.permute(0, 3, 1, 4, 2).reshape(
      th * tile_size, tw * tile_size, c)[:h, :w]
