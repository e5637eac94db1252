"""K14's plain version (``hpfrec_tpu_torch/ops/mt19937.py``) against
numpy's ``Generator(MT19937)``: the four tables of a seeded start hold the
bits of ``prior + 0.01 * random(n, dtype)`` in float32 and float64, from
the position that seeding leaves (623) and from others, with tables that
end in the middle of a 227-word step and of a 624-word twist, and float64
values whose two words fall in two steps.  The plain
version advances the kernel's ring in the kernel's steps, so it is the
kernel's oracle on the card (``tests/test_torch_kernels.py``).  On the
CPU ``initialize_state`` keeps drawing with numpy."""

import numpy as np
import pytest
import torch

from hpfrec_tpu_torch.ops import mt19937 as MT

DTYPES = {np.float32: torch.float32, np.float64: torch.float64}
PRIORS = (0.3, 0.25)


def _numpy_tables(g, n_u, n_i, dtype, priors=PRIORS):
    pu, pi = priors
    return [pu + 0.01 * g.random(n_u, dtype=dtype), pi + 0.01 * g.random(n_i, dtype=dtype),
            pu + 0.01 * g.random(n_u, dtype=dtype), pi + 0.01 * g.random(n_i, dtype=dtype)]


def _state(g):
    st = g.bit_generator.state["state"]
    return st["key"], st["pos"]


def _assert_bits(got, ref):
    assert len(got) == len(ref)
    for t, a in zip(got, ref):
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)


# (n_u, n_i) in values: a table under one step, ends in mid-step and in
# mid-twist, odd counts (float64: an odd number of two-word values), one
# table of a single value, several twists
SHAPES = [(1, 1), (3, 2), (7, 1), (217, 119), (227, 226), (623, 1), (624, 625), (791, 427),
          (4999, 3001)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_u,n_i", SHAPES)
def test_plain_tables_equal_numpy(dtype, n_u, n_i):
    g = np.random.Generator(np.random.MT19937(seed=123))
    key, pos = _state(g)
    assert pos == 623  # seeding leaves the stream's first word at key[623]
    got = MT.mt19937_tables(key, pos, n_u, n_i, *PRIORS, DTYPES[dtype], "cpu")
    _assert_bits(got, _numpy_tables(g, n_u, n_i, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ahead", [1, 2, 400, 624 + 17, 5 * 624])
def test_plain_tables_from_any_position(dtype, ahead):
    """Words drawn before the key is read move ``pos`` (to 624, just past a
    twist, mid-ring); the tables still follow numpy's stream."""
    g = np.random.Generator(np.random.MT19937(seed=7))
    g.random(ahead, dtype=np.float32)  # one word a value
    key, pos = _state(g)
    got = MT.mt19937_tables(key, pos, 300, 211, 0.2, 0.9, DTYPES[dtype], "cpu")
    _assert_bits(got, _numpy_tables(g, 300, 211, dtype, (0.2, 0.9)))


@pytest.mark.parametrize("seed", [1, 99, 2**31 + 11, 2**40 + 3])
def test_plain_tables_every_seed(seed):
    for dtype in DTYPES:
        g = np.random.Generator(np.random.MT19937(seed=seed))
        key, pos = _state(g)
        got = MT.mt19937_tables(key, pos, 350, 128, 0.3, 0.3, DTYPES[dtype], "cpu")
        _assert_bits(got, _numpy_tables(g, 350, 128, dtype, (0.3, 0.3)))


@pytest.mark.parametrize("step", [1, 100, 226, 227])
def test_any_step_up_to_227_gives_the_stream(step):
    g = np.random.Generator(np.random.MT19937(seed=5))
    key, pos = _state(g)
    words = MT._stream_plain(key, pos, 3000, step)
    ref = g.integers(0, 2**32, 3000, dtype=np.uint32, endpoint=False)
    g2 = np.random.Generator(np.random.MT19937(seed=5))
    # numpy's uint32 draws are the raw words: the tempered stream
    assert np.array_equal(g2.random(3000, dtype=np.float32),
                          ((words.numpy() >> 8) * 2.0 ** -24).astype(np.float32))
    assert np.array_equal(words.numpy().astype(np.uint32), ref)


def test_a_step_of_228_breaks_the_recurrence():
    """Word n reads word n - 227: a step one word wider reads a word of its
    own step before it is made."""
    g = np.random.Generator(np.random.MT19937(seed=5))
    key, pos = _state(g)
    assert not torch.equal(MT._stream_plain(key, pos, 3000, 228),
                           MT._stream_plain(key, pos, 3000, 227))


def test_words_per_value():
    assert MT.words_per_value(torch.float32) == 1
    assert MT.words_per_value(torch.float64) == 2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_start_is_drawn_by_numpy(monkeypatch, dtype):
    """``initialize_state`` on the CPU never takes K14's path, and its
    tables are numpy's."""
    from hpfrec_tpu_torch.models import state as ST

    def refuse(*a, **k):
        raise AssertionError("the CPU start must be numpy's")

    monkeypatch.setattr(MT, "mt19937_tables", refuse)
    hp = ST.Hyperparams(a_prime=0.2, c_prime=0.25, b_prime=1.5, d_prime=0.9, k=7)
    st = ST.initialize_state(31, 17, hp, 123, dtype, device="cpu")
    g = np.random.Generator(np.random.MT19937(seed=123))
    G_rte, L_rte, G_shp, L_shp = _numpy_tables(g, 31 * 7, 17 * 7, dtype, (0.2, 0.25))
    _assert_bits([st.G_shp.reshape(-1), st.G_rte.reshape(-1), st.L_shp.reshape(-1),
                  st.L_rte.reshape(-1)], [G_shp, G_rte, L_shp, L_rte])
    assert torch.equal(st.k_rte, torch.full((31, 1), 1.5, dtype=DTYPES[dtype]))
    assert torch.equal(st.t_rte, torch.full((17, 1), 0.9, dtype=DTYPES[dtype]))


@pytest.mark.parametrize("mode", [dict(), dict(users_per_batch=20, items_per_batch=15)])
def test_a_cpu_fit_draws_nothing_on_a_device(mode):
    """``device_draws`` is 0 on the host path, and ``bytes_to_device``
    still counts the state placed on the fit's device."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch import HPF

    rng = np.random.default_rng(1)
    X = coo_array((rng.poisson(2, 2500) + 1.0, (rng.integers(80, size=2500),
                                                rng.integers(60, size=2500))), shape=(80, 60))
    X.sum_duplicates()
    m = HPF(k=5, maxiter=8, check_every=4, stop_crit="train-llk", random_seed=3,
            verbose=False, device="cpu", **mode).fit(X)
    st = m.fit_stats_
    assert st.device_draws == 0
    state = (m.Gamma_shp, m.Gamma_rte, m.Lambda_shp, m.Lambda_rte, m.k_rte, m.t_rte)
    assert st.bytes_to_device >= sum(a.nbytes for a in state)
    assert "device_draws 0" in st.phase_report()
