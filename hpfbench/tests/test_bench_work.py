"""The work counts behind the rooflines and utilizations against counts
made by hand from small arrays."""

import numpy as np
import pytest

from hpfbench.work import cavi, topn
from hpfbench.work.peaks import least_seconds


def csr(n_rows, nnz, rng):
    rows = np.sort(rng.integers(0, n_rows, nnz))
    indptr = np.zeros(n_rows + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return indptr, rng.integers(0, 7, nnz).astype(np.int32), np.ones(nnz, np.float32)


@pytest.mark.parametrize("n_users,n_items,nnz,k", [(5, 3, 11, 4), (40, 17, 300, 9)])
def test_k1_k2_phi_sums_by_hand(n_users, n_items, nnz, k):
    rng = np.random.default_rng(0)
    t_tab = np.ones((n_users, k), np.float32)
    b_tab = np.ones((n_items, k), np.float32)
    side_u, side_i = csr(n_users, nnz, rng), csr(n_items, nnz, rng)
    # each side: its CSR, both tables read, its sums written
    by_hand = sum(sum(a.nbytes for a in side) + t_tab.nbytes + b_tab.nbytes
                  for side in (side_u, side_i)) + t_tab.nbytes + b_tab.nbytes
    flops = 2 * nnz * (2 * k + 2 * k)
    assert cavi.phi_sums(n_users, n_items, nnz, k) == (by_hand, flops)


@pytest.mark.parametrize("n_users,n_items,nnz,k", [(5, 3, 11, 4), (40, 17, 300, 9)])
def test_k4_llk_check_by_hand(n_users, n_items, nnz, k):
    rng = np.random.default_rng(1)
    theta = np.ones((n_users, k), np.float32)
    beta = np.ones((n_items, k), np.float32)
    by_hand = sum(a.nbytes for a in csr(n_users, nnz, rng)) + theta.nbytes + beta.nbytes
    assert cavi.llk_check(n_users, n_items, nnz, k) == (by_hand, nnz * (2 * k + 6))


@pytest.mark.parametrize("b,n_items,k,n", [(3, 10, 4, 2), (64, 1000, 50, 10)])
def test_k6_topn_call_by_hand(b, n_items, k, n):
    rows = np.ones((b, k), np.float32)
    beta = np.ones((n_items, k), np.float32)
    out = np.ones((b, n), np.int32).nbytes + np.ones((b, n), np.float32).nbytes
    scores = sum(1 for _ in range(b) for _ in range(n_items)) * k * 2
    assert topn.call(b, n_items, k, n) == (rows.nbytes + beta.nbytes + out, scores)


def test_table_update_and_iteration_add_up():
    n_u, n_i, nnz, k = 7, 5, 20, 3
    elems = (n_u + n_i) * k
    # sums read; shape, rate, exp table written; the row scalers read and written
    assert cavi.table_update(n_u, n_i, k) == (4 * 4 * elems + 2 * 4 * (n_u + n_i) + 2 * 4 * k,
                                              35 * elems)
    a, b = cavi.phi_sums(n_u, n_i, nnz, k), cavi.table_update(n_u, n_i, k)
    assert cavi.iteration(n_u, n_i, nnz, k) == (a[0] + b[0], a[1] + b[1])


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert least_seconds(3.35e12, 134e12) == pytest.approx(2.0)
