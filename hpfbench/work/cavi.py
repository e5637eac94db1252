"""Work of one full-batch CAVI iteration and of one train-llk check.

``n_users`` x ``n_items`` tables of ``k`` float32 factors,
``nnz`` nonzeros (a 4-byte value and a 4-byte column index each, and a
4-byte row pointer a row), as the CSR of each side holds them.

- phi sums of one side (K1 with K2's reassembly): the side's CSR, both
  exp tables, the (rows, k) sums written; 4k operations a nonzero (the
  dot of the two rows, then the scaled row added).  As ``chip_smoke.py``
  counts K1, but from the CSR rather than the ELL layout's padded slots.
- table update of one side (K3): the sums, the row scaler and the other
  side's colsum read; shape, rate, exp table and scaler written; 35
  operations an element (digamma, log, exp, the rate and the mean).
- a train-llk check (K4): Theta and Beta read once, the user side's CSR;
  a dot (2k) and ~6 operations a nonzero.
"""

from __future__ import annotations

F32 = 4


def _csr_bytes(nnz: int, n_rows: int) -> int:
    return 8 * nnz + 4 * (n_rows + 1)


def phi_sums(n_users: int, n_items: int, nnz: int, k: int):
    """(bytes, flops) of both sides' phi sums (K1 + K2) of one iteration."""
    tables = (n_users + n_items) * k * F32
    nbytes = (_csr_bytes(nnz, n_users) + _csr_bytes(nnz, n_items) + 2 * tables
              + (n_users + n_items) * k * F32)
    return nbytes, 2 * nnz * 4 * k


def table_update(n_users: int, n_items: int, k: int):
    """(bytes, flops) of both sides' K3 update of one iteration."""
    elems = (n_users + n_items) * k
    rows = n_users + n_items
    nbytes = elems * F32 * (1 + 3) + rows * F32 * 2 + 2 * k * F32
    return nbytes, 35 * elems


def iteration(n_users: int, n_items: int, nnz: int, k: int):
    """(bytes, flops) of one CAVI iteration."""
    a = phi_sums(n_users, n_items, nnz, k)
    b = table_update(n_users, n_items, k)
    return a[0] + b[0], a[1] + b[1]


def llk_check(n_users: int, n_items: int, nnz: int, k: int):
    """(bytes, flops) of one train-llk check (K4)."""
    return (_csr_bytes(nnz, n_users) + (n_users + n_items) * k * F32,
            nnz * (2 * k + 6))
