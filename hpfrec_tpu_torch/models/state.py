"""Variational state for Hierarchical Poisson Factorization (torch).

Port of ``hpfrec_tpu/models/state.py``: the same ``Hyperparams``, a
``VariationalState`` of six tensors, and the seeded MT19937 init drawn on
the host with numpy in the reference's order, so that a seed and dtype
give bit-identical starting parameters in both packages; and the
``default_rng`` draws of the rows that ``partial_fit`` grows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Hyperparams(NamedTuple):
    """Prior hyperparameters (plain Python floats)."""

    a: float = 0.3
    a_prime: float = 0.3
    b_prime: float = 1.0
    c: float = 0.3
    c_prime: float = 0.3
    d_prime: float = 1.0
    k: int = 30

    @property
    def k_shp(self) -> float:
        return self.a_prime + self.k * self.a

    @property
    def t_shp(self) -> float:
        return self.c_prime + self.k * self.c

    @property
    def add_k_rte(self) -> float:
        return self.a_prime / self.b_prime

    @property
    def add_t_rte(self) -> float:
        return self.c_prime / self.d_prime


class VariationalState(NamedTuple):
    """The six variational tensors.

    Shapes: ``G_shp``/``G_rte``: (nU, k); ``L_shp``/``L_rte``: (nI, k);
    ``k_rte``: (nU, 1); ``t_rte``: (nI, 1).
    """

    G_shp: torch.Tensor
    G_rte: torch.Tensor
    L_shp: torch.Tensor
    L_rte: torch.Tensor
    k_rte: torch.Tensor
    t_rte: torch.Tensor

    @property
    def Theta(self) -> torch.Tensor:
        return self.G_shp / self.G_rte

    @property
    def Beta(self) -> torch.Tensor:
        return self.L_shp / self.L_rte

    @property
    def nusers(self) -> int:
        return self.G_shp.shape[0]

    @property
    def nitems(self) -> int:
        return self.L_shp.shape[0]

    @property
    def k(self) -> int:
        return self.G_shp.shape[1]


def state_from_numpy(arrays, device) -> VariationalState:
    """A ``VariationalState`` on ``device`` from six host arrays in state
    order (``G_shp, G_rte, L_shp, L_rte, k_rte, t_rte``), e.g. the JAX
    package's fitted ``Gamma_shp ... t_rte`` attributes or the arrays of
    its checkpoints."""
    arrays = list(arrays)
    if len(arrays) != 6:
        raise ValueError("expected the six state arrays, got %d" % len(arrays))
    return VariationalState(*[
        torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)
        for a in arrays])


def initialize_state(nusers: int, nitems: int, hp: Hyperparams,
                     random_seed: int | None, dtype=np.float32,
                     device="cpu") -> VariationalState:
    """Seeded random initialization (reference
    ``cython_loops.pxi:117-143``): the MT19937 bitstream and draw order
    (G_rte, L_rte, G_shp, L_shp as ``prior + 0.01*U(0,1)``) of
    ``hpfrec_tpu.models.state.initialize_state``, drawn on the host and
    then moved to ``device``."""
    seed = random_seed if (random_seed is not None and random_seed > 0) else None
    rng = np.random.Generator(np.random.MT19937(seed=seed))
    k = hp.k

    k_rte = np.full((nusers, 1), hp.b_prime, dtype=dtype)
    t_rte = np.full((nitems, 1), hp.d_prime, dtype=dtype)
    G_rte = hp.a_prime + 0.01 * rng.random(size=(nusers, k), dtype=dtype)
    L_rte = hp.c_prime + 0.01 * rng.random(size=(nitems, k), dtype=dtype)
    G_shp = hp.a_prime + 0.01 * rng.random(size=(nusers, k), dtype=dtype)
    L_shp = hp.c_prime + 0.01 * rng.random(size=(nitems, k), dtype=dtype)
    return state_from_numpy((G_shp, G_rte, L_shp, L_rte, k_rte, t_rte), device)


def initialize_extra_rows(n: int, prime: float, scaler_prime: float, k: int,
                          seed: int | None, dtype=np.float32):
    """New-row initialization for model growth (``partial_fit(new_users=True)``;
    reference ``hpfrec/__init__.py:933-963``): shp/rte ~ prime +
    0.01*U(0,1), scaler rate = scaler_prime.  Host numpy, the draws of
    ``hpfrec_tpu.models.state.initialize_extra_rows`` verbatim."""
    rng = np.random.default_rng(seed=seed if (seed is not None and seed > 0) else None)
    new_shp = (prime + 0.01 * rng.random(size=(n, k), dtype=dtype)).astype(dtype)
    new_rte = (prime + 0.01 * rng.random(size=(n, k), dtype=dtype)).astype(dtype)
    new_scaler = np.full((n, 1), scaler_prime, dtype=dtype)
    return new_shp, new_rte, new_scaler
