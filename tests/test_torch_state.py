"""hpfrec_tpu_torch.models.state against hpfrec_tpu.models.state: the
seeded MT19937 init must be bit-equal in float32 and float64."""

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it: the flag is process-wide
    and would leak into the next test file on this worker."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [None, 0, 123])
def test_initialize_state_bit_equal(monkeypatch, dtype, seed):
    import jax

    from hpfrec_tpu.models import state as J
    from hpfrec_tpu_torch.models import state as T

    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    if seed is None or seed <= 0:
        # seeds None and 0 draw fresh OS entropy in both packages; pin the
        # generator so that the two draws can be compared
        orig = np.random.MT19937
        monkeypatch.setattr(np.random, "MT19937",
                            lambda seed=None: orig(seed=99 if seed is None else seed))
    hp_j = J.Hyperparams(a=0.4, a_prime=0.2, b_prime=1.5, c=0.35, c_prime=0.25,
                         d_prime=0.9, k=7)
    hp_t = T.Hyperparams(*hp_j)
    sj = J.initialize_state(31, 17, hp_j, seed, dtype)
    st = T.initialize_state(31, 17, hp_t, seed, dtype, device="cpu")
    for a, b in zip(sj, st):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


def test_hyperparams_derived_values_match():
    from hpfrec_tpu.models.state import Hyperparams as HJ
    from hpfrec_tpu_torch.models.state import Hyperparams as HT

    hj, ht = HJ(k=13, a=0.2, c=0.7), HT(k=13, a=0.2, c=0.7)
    assert (hj.k_shp, hj.t_shp, hj.add_k_rte, hj.add_t_rte) == \
        (ht.k_shp, ht.t_shp, ht.add_k_rte, ht.add_t_rte)


def test_state_from_numpy_roundtrip():
    from hpfrec_tpu_torch.models.state import VariationalState, state_from_numpy

    rng = np.random.default_rng(0)
    arrs = [rng.random((5, 3)), rng.random((5, 3)), rng.random((4, 3)),
            rng.random((4, 3)), rng.random((5, 1)), rng.random((4, 1))]
    st = state_from_numpy(arrs, "cpu")
    assert isinstance(st, VariationalState)
    for a, t in zip(arrs, st):
        np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError):
        state_from_numpy(arrs[:5], "cpu")
