"""Kohonen self-organising map, trained on the card.

Port of `senas_tpu/som.py` (the reference's orphan SOM module,
kohonen/productionized_kohonen.py:17-175): the same public API (fit /
predict / quantization_error / topographic_error / save / load), the same
constructor validation, exponential radius and learning-rate decay, online
updates one sample at a time and the recorded history.

`fit` runs the JAX package's `_train` scan as an online loop of PyTorch
ops on `device` (None means the card), in f32 and in the JAX package's
order of operations: for each iteration t the radius and rate
r0 * exp(-t / T), then for each sample its best-matching unit (the first
argmin of the squared distances over the grid, at grid position
(idx // height, idx % height)), and the update w + lr * influence *
(v - w) with influence exp(-d_grid^2 / (2 r^2)). The loop never reads a
value back to the host. The initial weights are
`np.random.default_rng(random_state).random(...)`, as in the JAX package,
so both start from the same numbers. The weights come back as float64
numpy, and `predict` and the errors are numpy, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from senas_torch.core.device import resolve_device

logger = logging.getLogger(__name__)


def _quantization_error(w: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Mean over samples of the distance to the nearest node, the norm of
    the explicit difference (as jnp.linalg.norm takes it)."""
    flat = w.reshape(-1, w.shape[-1])
    diff = data[:, None, :] - flat[None]
    return torch.sqrt((diff * diff).sum(dim=2)).min(dim=1).values.mean()


def train_som(weights: torch.Tensor, data: torch.Tensor, coords: torch.Tensor, *,
              height: int, n_iterations: int, initial_radius: float, time_constant: float,
              initial_lr: float, record_history: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The JAX package's `_train` (senas_tpu/som.py:27-59) as a loop on the
    weights' device, in their dtype (`fit` gives f32, as JAX trains; f64
    weights, data and coords take every step in f64): (weights, the
    per-iteration quantization errors as 0-d tensors, empty without
    `record_history`)."""
    w = weights.clone()
    history = []
    # a divisor on the device: the card multiplies by the reciprocal of a
    # host scalar, where JAX divides
    tc = torch.tensor(time_constant, dtype=w.dtype, device=w.device)
    for step in range(n_iterations):
        t = torch.tensor(float(step), dtype=w.dtype, device=w.device)
        decay = torch.exp(-t / tc)
        radius = initial_radius * decay
        lr = initial_lr * decay
        two_r2 = 2.0 * radius ** 2
        for vector in data:
            sq = ((w - vector) ** 2).sum(dim=-1)               # (W, H)
            flat_idx = torch.argmin(sq)
            bx = torch.div(flat_idx, height, rounding_mode="floor")
            by = flat_idx % height
            grid_sq = (coords[0] - bx) ** 2 + (coords[1] - by) ** 2
            influence = torch.exp(-grid_sq / two_r2)
            w = w + lr * influence[..., None] * (vector - w)
        if record_history:
            history.append(_quantization_error(w, data))
    return w, history


class KohonenSOM:
    """Self-organising map on a width x height grid.

    The reference's constructor contract (validation, radius and time
    constant with the small-grid log guard, seeded init); `device` is
    where `fit` trains (None means the card, which raises without one)."""

    def __init__(self, width: int, height: int, n_iterations: int = 100,
                 initial_learning_rate: float = 0.1,
                 random_state: Optional[int] = None, device=None) -> None:
        if width < 1 or height < 1:
            raise ValueError("width and height must be >= 1")
        if n_iterations < 1:
            raise ValueError("n_iterations must be >= 1")
        self.width = width
        self.height = height
        self.n_iterations = n_iterations
        self.initial_learning_rate = initial_learning_rate
        self.random_state = random_state
        self.device = device

        self.initial_radius = max(width, height) / 2.0
        log_radius = (np.log(self.initial_radius)
                      if self.initial_radius > 1 else 1.0)
        self.time_constant = n_iterations / log_radius

        self.weights: Optional[np.ndarray] = None
        self.quantization_error_history_: List[float] = []

    # ------------------------------------------------------------------
    def _check_fitted(self) -> None:
        if self.weights is None:
            raise RuntimeError("SOM is not trained yet -- call fit() first.")

    def _validate(self, data) -> np.ndarray:
        data = np.asarray(data, dtype=float)
        if data.ndim != 2 or data.shape[0] == 0:
            raise ValueError(
                "data must be a non-empty 2D array (n_samples, n_features)")
        return data

    def _best_matching_unit(self, vector: np.ndarray) -> Tuple[int, int]:
        self._check_fitted()
        sq = np.sum((self.weights - np.asarray(vector)) ** 2, axis=-1)
        return tuple(np.unravel_index(np.argmin(sq), sq.shape))

    def _distances_to_nodes(self, data: np.ndarray) -> np.ndarray:
        flat = self.weights.reshape(-1, self.weights.shape[-1])
        return np.linalg.norm(np.asarray(data)[:, None, :] - flat[None], axis=2)

    # ------------------------------------------------------------------
    def fit(self, data, record_history: bool = False) -> "KohonenSOM":
        data = self._validate(data)
        dev = resolve_device(self.device)
        n_features = data.shape[1]
        rng = np.random.default_rng(self.random_state)
        init = rng.random((self.width, self.height, n_features))
        gx, gy = torch.meshgrid(torch.arange(self.width), torch.arange(self.height),
                                indexing="ij")
        coords = torch.stack([gx, gy]).to(dev, torch.float32)
        logger.info("Training SOM: grid=%dx%d iters=%d n=%d d=%d",
                    self.width, self.height, self.n_iterations,
                    data.shape[0], n_features)
        weights, history = train_som(
            torch.as_tensor(init, dtype=torch.float32, device=dev),
            torch.as_tensor(data, dtype=torch.float32, device=dev), coords,
            height=self.height, n_iterations=self.n_iterations,
            initial_radius=float(self.initial_radius),
            time_constant=float(self.time_constant),
            initial_lr=float(self.initial_learning_rate),
            record_history=record_history)
        self.weights = weights.cpu().numpy().astype(float)
        self.quantization_error_history_ = (
            torch.stack(history).cpu().tolist() if record_history else [])
        return self

    def predict(self, data) -> np.ndarray:
        self._check_fitted()
        data = self._validate(data)
        nearest = self._distances_to_nodes(data).argmin(axis=1)
        xs, ys = np.unravel_index(nearest, (self.width, self.height))
        return np.stack([xs, ys], axis=1)

    def quantization_error(self, data) -> float:
        self._check_fitted()
        data = self._validate(data)
        return float(self._distances_to_nodes(data).min(axis=1).mean())

    def topographic_error(self, data) -> float:
        self._check_fitted()
        data = self._validate(data)
        nearest_two = np.argsort(self._distances_to_nodes(data), axis=1)[:, :2]
        xs, ys = np.unravel_index(nearest_two, (self.width, self.height))
        non_adjacent = ((np.abs(xs[:, 0] - xs[:, 1]) > 1)
                        | (np.abs(ys[:, 0] - ys[:, 1]) > 1))
        return float(np.mean(non_adjacent))

    def save(self, path: str) -> None:
        np.save(path, self.weights)

    def load(self, path: str) -> "KohonenSOM":
        if not str(path).endswith(".npy"):
            path = str(path) + ".npy"
        self.weights = np.load(path)
        return self
