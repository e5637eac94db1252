"""The plain references against the port's CPU path at a tiny size."""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_array

from hpfbench import data
from hpfbench.reference import hpf as R
from hpfbench.reference import topn as RT
from hpfbench.tests.small import config


def fit_port(cfg, iu, ii, y, iters, seed, dtype):
    from hpfrec_tpu_torch import HPF

    m = HPF(k=cfg["k"], **cfg["prior"], stop_crit="maxiter", maxiter=iters, random_seed=seed,
            verbose=False, use_float=dtype == np.float32, device="cpu")
    return m.fit(coo_array((y.astype(dtype), (iu, ii)), shape=(cfg["n_users"], cfg["n_items"])))


@pytest.mark.parametrize("name", ["tasteprofile-k50", "movielens20m-k30"])
def test_cavi_reference_matches_the_port_in_float64(name):
    cfg = config(name)
    iu, ii, y = data.host_triplets(cfg, 3, "cpu")
    m = fit_port(cfg, iu, ii, y, 12, 5, np.float64)
    prior = R.Prior(**cfg["prior"], k=cfg["k"])
    ref = R.CAVI(y, iu, ii, cfg["n_users"], cfg["n_items"], prior,
                 R.initial_state(cfg["n_users"], cfg["n_items"], prior, 5, np.float64), "cpu",
                 block=1000)
    for _ in range(12):
        ref.step()
    np.testing.assert_allclose(m.Theta, ref.Theta.numpy(), rtol=1e-9)
    np.testing.assert_allclose(m.Beta, ref.Beta.numpy(), rtol=1e-9)
    np.testing.assert_allclose(m.Gamma_rte, ref.G_rte.numpy(), rtol=1e-9)
    np.testing.assert_allclose(m.t_rte, ref.t_rte.numpy(), rtol=1e-9)


def test_initial_state_is_the_ports():
    from hpfrec_tpu_torch.models.state import Hyperparams, initialize_state

    cfg = config("tasteprofile-k50")
    prior = R.Prior(**cfg["prior"], k=cfg["k"])
    mine = R.initial_state(50, 40, prior, 99, np.float32)
    port = initialize_state(50, 40, Hyperparams(**cfg["prior"], k=cfg["k"]), 99, np.float32)
    for a, b in zip(mine, port):
        np.testing.assert_array_equal(a, b.numpy())


def test_train_llk_matches_the_port():
    cfg = config("tasteprofile-k50")
    iu, ii, y = data.host_triplets(cfg, 4, "cpu")
    from hpfrec_tpu_torch import HPF

    m = HPF(k=cfg["k"], **cfg["prior"], stop_crit="train-llk", check_every=5, maxiter=5,
            random_seed=8, verbose=False, use_float=False, device="cpu")
    m.fit(coo_array((y.astype(np.float64), (iu, ii)), shape=(cfg["n_users"], cfg["n_items"])))
    prior = R.Prior(**cfg["prior"], k=cfg["k"])
    ref = R.CAVI(y, iu, ii, cfg["n_users"], cfg["n_items"], prior,
                 R.initial_state(cfg["n_users"], cfg["n_items"], prior, 8, np.float64), "cpu")
    for _ in range(5):
        ref.step()
    assert ref.train_llk() == pytest.approx(m.train_llk, rel=1e-7)


def test_topn_gap_is_zero_for_the_ports_answers():
    cfg = config("tasteprofile-k50")
    theta, beta = data.gamma_factors(cfg, 5, "cpu")
    from hpfrec_tpu_torch.ops.topk import topn_batch

    users = np.arange(0, cfg["n_users"], 3)
    idx = topn_batch(theta.numpy(), beta, users, 10)
    g = RT.gaps(theta, beta, torch.from_numpy(users), torch.from_numpy(idx).long(), block=64)
    assert float(g.max()) < 1e-6


def test_topn_gap_sees_a_wrong_or_repeated_item():
    theta = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    beta = torch.tensor([[3.0, 0], [2.0, 0], [1.0, 0]], dtype=torch.float64)
    u = torch.tensor([0])
    assert float(RT.gaps(theta, beta, u, torch.tensor([[0, 1]]))[0]) == 0.0
    assert float(RT.gaps(theta, beta, u, torch.tensor([[0, 2]]))[0]) == pytest.approx(1 / 3)
    assert float(RT.gaps(theta, beta, u, torch.tensor([[1, 1]]))[0]) == float("inf")
    assert float(RT.gaps(theta, beta, u, torch.tensor([[0, 3]]))[0]) == float("inf")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, 3.0])
    r = RT.round_tf32(x)
    assert r.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, 3.0]
