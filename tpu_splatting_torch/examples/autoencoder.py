"""Fourier-feature position autoencoder (side experiment): the counterpart
of ``examples/autoencoder.py``.

An MLP autoencoder over 2D positions whose input encoding is random
sin / cos projections (Fourier features), trained by the reference's
hand-written Adam step on the mean squared reconstruction error.  Not
coupled to splatting and runs no kernel of the port: plain torch on the
card or the CPU.  The weights keep the reference's layout (``x @ W + b``,
W of shape (in, out)) so that ``from_reference`` carries its parameters
across as numpy arrays.  Random numbers come from a ``torch.Generator``
seeded by ``--seed``: the same seed gives other draws than the
reference's ``jax.random``.

    python -m tpu_splatting_torch.examples.autoencoder [--n 10000]
        [--steps 500] [--lr 1e-3] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


class MLP(nn.Module):
  """Linear layers with ReLU between them (reference ``init_mlp``,
  ``mlp_apply``): weights normal with std 1 / sqrt(fan_in), the last
  layer's ``output_scale`` where given, biases zero."""

  def __init__(self, sizes: Sequence[int], generator: torch.Generator,
               output_scale: float | None = None, dtype=torch.float32,
               device="cpu"):
    super().__init__()
    self.weights = nn.ParameterList()
    self.biases = nn.ParameterList()
    last = len(sizes) - 2
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
      std = (output_scale if output_scale is not None and i == last
             else 1.0 / math.sqrt(fan_in))
      w = torch.randn((fan_in, fan_out), generator=generator, dtype=dtype,
                      device=device) * std
      self.weights.append(nn.Parameter(w))
      self.biases.append(nn.Parameter(torch.zeros(fan_out, dtype=dtype,
                                                  device=device)))

  def forward(self, x):
    for i, (w, b) in enumerate(zip(self.weights, self.biases)):
      x = x @ w + b
      if i < len(self.weights) - 1:
        x = torch.relu(x)
    return x


class Autoencoder(nn.Module):
  """Positions (N, in_dim) -> sin / cos of random projections (N, 2 *
  n_proj) -> encoder -> latent (N, latent) -> decoder -> (N, in_dim)
  (reference ``make_autoencoder``; the projections are trained too, as
  the reference's Adam step updates every parameter)."""

  def __init__(self, generator: torch.Generator, in_dim=2, latent=8,
               n_proj=64, hidden: Sequence[int] = (128, 128),
               dtype=torch.float32, device="cpu"):
    super().__init__()
    self.proj = nn.Parameter(torch.randn(
        (in_dim, n_proj), generator=generator, dtype=dtype,
        device=device) * 4.0)
    self.encoder = MLP([2 * n_proj, *hidden, latent], generator,
                       dtype=dtype, device=device)
    self.decoder = MLP([latent, *hidden, in_dim], generator,
                       output_scale=1e-2, dtype=dtype, device=device)

  def encode(self, x):
    p = x @ self.proj
    return self.encoder(torch.cat([torch.sin(p), torch.cos(p)], -1))

  def forward(self, x):
    """(latent, reconstruction)."""
    z = self.encode(x)
    return z, self.decoder(z)


def from_reference(params: dict, device="cpu") -> Autoencoder:
  """An ``Autoencoder`` holding the reference's parameters, given as numpy
  arrays: {"proj": (in_dim, n_proj), "encoder": [(W, b), ...], "decoder":
  [(W, b), ...]} (``jax.device_get`` of ``make_autoencoder``'s result),
  in their dtype."""
  proj = torch.tensor(np.asarray(params["proj"]))
  enc, dec = params["encoder"], params["decoder"]
  model = Autoencoder(torch.Generator().manual_seed(0), proj.shape[0],
                      np.asarray(enc[-1][0]).shape[1], proj.shape[1],
                      [np.asarray(w).shape[1] for w, _ in enc[:-1]],
                      dtype=proj.dtype, device=device)
  with torch.no_grad():
    model.proj.copy_(proj)
    for mlp, layers in ((model.encoder, enc), (model.decoder, dec)):
      for k, (w, b) in enumerate(layers):
        mlp.weights[k].copy_(torch.tensor(np.asarray(w)))
        mlp.biases[k].copy_(torch.tensor(np.asarray(b)))
  return model


def loss_of(model: Autoencoder, x):
  """Mean squared reconstruction error."""
  return ((model(x)[1] - x) ** 2).mean()


class Adam:
  """The reference's hand-written Adam step (betas 0.9, 0.999, eps 1e-8,
  bias-corrected), in place on the model's parameters."""

  def __init__(self, params, lr: float):
    self.params = list(params)
    self.lr, self.t = lr, 0
    self.m = [torch.zeros_like(p) for p in self.params]
    self.v = [torch.zeros_like(p) for p in self.params]

  @torch.no_grad()
  def step(self, grads):
    self.t += 1
    for p, g, m, v in zip(self.params, grads, self.m, self.v):
      m.mul_(0.9).add_(0.1 * g)
      v.mul_(0.999).add_(0.001 * g * g)
      mh = m / (1 - 0.9 ** self.t)
      vh = v / (1 - 0.999 ** self.t)
      p.sub_(self.lr * mh / (torch.sqrt(vh) + 1e-8))


def fit(model: Autoencoder, positions, steps: int, lr: float,
        verbose: bool = False) -> float:
  """``steps`` Adam steps on the reconstruction loss; returns the loss of
  the last step (before its update), as the reference's ``train``."""
  opt = Adam(model.parameters(), lr)
  loss = None
  for i in range(steps):
    loss = loss_of(model, positions)
    opt.step(torch.autograd.grad(loss, opt.params))
    if verbose and (i + 1) % 100 == 0:
      print(f"step {i + 1}: loss {float(loss.detach()):.6f}")
  return float(loss.detach())


def train(n=10_000, steps=500, lr=3e-3, seed=0, verbose=True,
          device="cpu"):
  """Positions uniform in [-1, 1)^2 and the model from one seeded
  generator, then ``fit``: (model, final loss)."""
  gen = torch.Generator(device=device).manual_seed(seed)
  positions = torch.rand((n, 2), generator=gen, device=device) * 2.0 - 1.0
  model = Autoencoder(gen, device=device)
  return model, fit(model, positions, steps, lr, verbose)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--n", type=int, default=10_000)
  parser.add_argument("--steps", type=int, default=500)
  parser.add_argument("--lr", type=float, default=1e-3)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  args = parser.parse_args(argv)
  if args.device.startswith("cuda") and not torch.cuda.is_available():
    raise RuntimeError("autoencoder: CUDA is not available (--device cpu "
                       "runs on the CPU)")
  _, loss = train(args.n, args.steps, args.lr, args.seed,
                  device=args.device)
  print(f"final reconstruction loss: {loss:.6f}")
  return loss


if __name__ == "__main__":
  main()
