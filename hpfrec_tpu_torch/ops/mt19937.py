"""The seeded MT19937 start of a fit's state from a seeded generator's key
(K14, ``csrc/mt19937_init.cu``).

Numpy's ``Generator(MT19937(seed))`` is a 624-word key and a position
``pos`` (623 after seeding).  Word ``t`` of its stream is ``x[pos + t]``
tempered, where ``x[0..623]`` is the key and ``x[n] = x[n - 227] ^
twist(x[n - 624], x[n - 623])``; ``random(dtype=float32)`` makes a value
of one word, ``(w >> 8) * 2**-24``, and ``random()`` (float64) of two,
``((w0 >> 5) * 2**26 + (w1 >> 6)) * 2**-53``.  ``mt19937_tables`` draws
the four tables of a start from one such stream, in the order
``models/state.py`` draws them with numpy (G_rte, L_rte, G_shp, L_shp),
each value ``prior + 0.01 * u`` in the dtype, and gives the same bits as
numpy.  CUDA: one call of the kernels (counted in
``mt19937_tables.launches``): the recurrence into a scratch stream of raw
words on one CTA, then a pass a table that tempers and converts them; CPU:
the plain version below, which advances the same ring in the same 227-word
steps with int64 tensor ops (the kernels' oracle in their tests;
``initialize_state`` draws on the CPU with numpy).
"""

from __future__ import annotations

import numpy as np
import torch

MT_N = 624
MT_LAG = 227  # words a step computes: word n reads n - 624, n - 623, n - 227
RING = 1024
MATRIX_A = 0x9908B0DF


def words_per_value(dtype) -> int:
    """MT19937 words numpy's ``random`` takes for one value of ``dtype``."""
    return dtype.itemsize // 4


def _temper(y):
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def _stream_plain(key, pos: int, n_words: int, step: int):
    """Words ``0..n_words-1`` of the stream, tempered, as int64: the ring of
    ``RING`` slots advanced ``step`` words at a time (the kernel's 227, or
    any step up to it)."""
    ring = torch.zeros(RING, dtype=torch.int64)
    ring[:MT_N] = torch.from_numpy(np.asarray(key, dtype=np.uint32).astype(np.int64))
    out = torch.empty(n_words, dtype=torch.int64)
    for t0 in range(0, n_words, step):
        m = torch.arange(pos + t0, pos + min(t0 + step, n_words))
        y = (ring[(m - MT_N) % RING] & 0x80000000) | (ring[(m - MT_N + 1) % RING] & 0x7FFFFFFF)
        x = ring[(m - MT_LAG) % RING] ^ (y >> 1) ^ ((y & 1) * MATRIX_A)
        x = torch.where(m < MT_N, ring[m % RING], x)
        ring[m % RING] = x
        out[t0:t0 + m.numel()] = _temper(x)
    return out


def _mt19937_tables_plain(key, pos, n_u, n_i, prior_u, prior_i, dtype):
    w = words_per_value(dtype)
    n_values = 2 * (n_u + n_i)
    words = _stream_plain(key, pos, n_values * w, MT_LAG)
    if w == 1:
        u = (words >> 8).to(dtype) * torch.tensor(2.0 ** -24, dtype=dtype)
    else:
        u = ((words[0::2] >> 5) * 67108864 + (words[1::2] >> 6)).to(dtype) \
            * torch.tensor(2.0 ** -53, dtype=dtype)
    scale = torch.tensor(0.01, dtype=dtype)
    ends = np.cumsum([0, n_u, n_i, n_u, n_i])
    priors = (prior_u, prior_i, prior_u, prior_i)
    return tuple(torch.tensor(p, dtype=dtype) + scale * u[ends[q]:ends[q + 1]]
                 for q, p in enumerate(priors))


def mt19937_tables(key, pos: int, n_u: int, n_i: int, prior_u: float, prior_i: float,
                   dtype, device):
    """The start's four flat tables ``(G_rte, L_rte, G_shp, L_shp)`` of
    ``n_u``, ``n_i``, ``n_u`` and ``n_i`` values (``prior_u`` or
    ``prior_i`` + 0.01 U(0, 1)) in ``dtype`` on ``device``, drawn from the
    MT19937 stream of ``key`` (624 uint32) at ``pos``: numpy's
    ``random(n, dtype)`` from that state, four times in that order."""
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(t.to(device) for t in _mt19937_tables_plain(
            key, pos, n_u, n_i, prior_u, prior_i, dtype))
    from .. import _cuda

    key_dev = torch.from_numpy(np.asarray(key, dtype=np.uint32).view(np.int32)).to(device)
    words = torch.empty(2 * (n_u + n_i) * words_per_value(dtype), dtype=torch.int32,
                        device=device)
    tables = tuple(torch.empty(n, dtype=dtype, device=device) for n in (n_u, n_i, n_u, n_i))
    _cuda.launch("mt19937_init", dtype, None, key_dev, int(pos), words, *tables, n_u, n_i,
                 float(prior_u), float(prior_i))
    mt19937_tables.launches += 1
    return tables


mt19937_tables.launches = 0
