"""Work of a batch top-n call (K6): ``b`` users' rows of Theta and all of
Beta read once, the (b, n) item ids and scores written (8 bytes an
entry); 2 b n_items k operations (every user's score of every item)."""

from __future__ import annotations


def call(b: int, n_items: int, k: int, n: int):
    """(bytes, flops) of ranking ``b`` users over ``n_items`` items, the
    tables in float32."""
    return (4 * b * k + 4 * n_items * k + b * n * 8,
            2 * b * n_items * k)
