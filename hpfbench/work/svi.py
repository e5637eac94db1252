"""Work of one SVI batch: K7's phi sums and K8's blend.

``n_users`` x ``n_items`` tables of ``k`` float32 factors; a batch holds
``rows`` rows of its own (local) side, whose ``slots`` training nonzeros
touch ``other_rows`` rows of the other side.  As ``chip_smoke.py`` counts
them:

- K7 (``batch_phi_sums``): the batch's slots of ``y`` / row / column in
  the epoch stream (12 bytes a slot), its rows' ids and offsets (8 bytes a
  row) and their exp-table rows, the touched rows of the other side's
  table, each read once; both sides' (n, k) sums and the other side's
  (n, 1) mask written.  A dot and two k-wide multiply-adds a slot, 6k + 2
  operations.  The wrapper's stable sort of the batch's column ids (a
  library radix sort) and its fills are in neither the count nor the time
  the roofline reads.
- K8 (``svi_update``, both sides' ``svi_pass_kernel``): the local side's
  shape, sums, scaler and mask read, the other (global) side's shape,
  rate, sums, scaler and mask read; every row's shape, rate and scaler
  written on both sides; about 10 operations an element.  The row mask
  (``row_mask_kernel``) is left aside.
"""

from __future__ import annotations

F32 = 4


def batch_phi_sums(rows: int, slots: int, other_rows: int, n_loc: int, n_oth: int, k: int):
    """(bytes, flops) of K7 on one batch, ``n_loc`` / ``n_oth`` the rows of
    the batch's own side and of the other."""
    row = k * F32
    nbytes = (slots * 12 + rows * (row + 8) + other_rows * row
              + (n_loc + n_oth) * row + n_oth)
    return nbytes, slots * (6 * k + 2)


def blend(n_loc: int, n_glb: int, k: int):
    """(bytes, flops) of K8 on one batch whose own side has ``n_loc`` rows
    and the other ``n_glb``."""
    row = k * F32
    n = n_loc + n_glb
    nbytes = (2 * n_loc + 3 * n_glb) * row + n * (F32 + 1) + 2 * n * row + n * F32
    return nbytes, 10 * n * k
