"""``ops.staging.to_host``, the one path by which a fit's results come
back to the host: every array equal to ``t.cpu().numpy()`` bit for bit,
owning its memory, never sharing it with another call's; the chunked
copy at sizes around its chunk (a small chunk set through its private
argument); the native threaded byte copy against ``np.copyto`` at the
edges of its blocks; and a fit's factors and counters through it.  On the
CPU no tensor crosses the pinned ring (the card's tests are in
``test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_array

from hpfrec_tpu_torch import HPF, _native
from hpfrec_tpu_torch.ops import staging
from hpfrec_tpu_torch.ops.staging import to_host

CHUNK = 64  # bytes
DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64]


def _tensor(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(n, generator=g, dtype=dtype)
    return torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nbytes", [0, 1, CHUNK // 2, CHUNK, 7 * CHUNK + 24],
                         ids=["empty", "one", "under_a_chunk", "a_chunk", "chunks_and_a_rest"])
def test_to_host_equals_cpu_numpy_bit_for_bit(dtype, nbytes):
    """Sizes 0 and 1, under one chunk, exactly one chunk, and many chunks
    with a remainder (in elements of the dtype)."""
    item = torch.empty((), dtype=dtype).element_size()
    n = nbytes if nbytes <= 1 else nbytes // item
    t = _tensor(n, dtype)
    (a,) = to_host([t], _chunk_bytes=CHUNK)
    ref = t.numpy()
    assert a.dtype == ref.dtype and a.shape == ref.shape
    assert a.tobytes() == ref.tobytes()


def test_to_host_keeps_order_shapes_and_bits_of_many_tensors():
    ts = [_tensor(600, torch.float32).view(20, 30), _tensor(5, torch.float64, 1).view(5, 1),
          torch.tensor(3.5, dtype=torch.float64), _tensor(0, torch.int32),
          _tensor(1000, torch.int64, 2).view(10, 100).t()]
    got = to_host(ts, _chunk_bytes=CHUNK)
    assert len(got) == len(ts)
    for a, t in zip(got, ts):
        ref = t.contiguous().numpy()
        assert a.shape == ref.shape and a.dtype == ref.dtype and a.tobytes() == ref.tobytes()
        assert a.flags.c_contiguous


def test_to_host_arrays_own_their_memory():
    t = _tensor(1000, torch.float32)
    a, b = to_host([t, t], _chunk_bytes=CHUNK)
    for x in (a, b):
        assert x.flags.owndata and x.base is None
        x.flags.writeable = False
        x.flags.writeable = True
        x[0] = 7.0
    assert b[1] == t[1].item() and t[0].item() != 7.0
    assert not np.shares_memory(a, b) and not np.shares_memory(a, t.numpy())


def test_a_second_call_leaves_the_first_calls_arrays_untouched():
    t1, t2 = _tensor(5000, torch.float64), _tensor(5000, torch.float64, 1)
    (a,) = to_host([t1], _chunk_bytes=CHUNK)
    before = a.copy()
    (b,) = to_host([t2], _chunk_bytes=CHUNK)
    assert a.tobytes() == before.tobytes() == t1.numpy().tobytes()
    assert b.tobytes() == t2.numpy().tobytes()
    assert not np.shares_memory(a, b)


def test_to_host_without_the_native_helpers_gives_the_same_bits(monkeypatch):
    t = _tensor(3001, torch.float32).view(3001, 1)
    want = to_host([t], _chunk_bytes=CHUNK)[0]
    monkeypatch.setattr(_native, "available", lambda: False)
    got = to_host([t], _chunk_bytes=CHUNK)[0]
    assert got.tobytes() == want.tobytes() == t.numpy().tobytes()


@pytest.mark.parametrize("chunk", [0, staging.CHUNK_BYTES + 1])
def test_to_host_refuses_a_chunk_outside_the_ring(chunk):
    with pytest.raises(ValueError):
        to_host([_tensor(4, torch.float32)], _chunk_bytes=chunk)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("n,block", [(0, 16), (1, 16), (15, 16), (16, 16), (17, 16),
                                     (16 * 9, 16), (16 * 9 + 5, 16), (1000, 1), (1000, 1 << 21)])
def test_native_copy_bytes_equals_copyto(threads, n, block):
    """The threaded byte copy at 1 and 4 threads, at the edges of its
    blocks: inside a block, at one, one past it, many and a rest."""
    if not _native.available():
        pytest.skip("native helpers unavailable: %s" % _native.load_error())
    rng = np.random.default_rng(n + block)
    src = rng.integers(0, 256, n + 3, dtype=np.uint8)
    want = np.full(n + 3, 0xAB, dtype=np.uint8)
    got = want.copy()
    np.copyto(want[1:n + 1], src[2:n + 2])
    _native.set_num_threads(threads)
    try:
        _native.copy_bytes(got[1:n + 1], src[2:n + 2], block)
    finally:
        _native.set_num_threads(0)
    assert got.tobytes() == want.tobytes()


def test_native_copy_bytes_checks_its_arguments():
    if not _native.available():
        pytest.skip("native helpers unavailable: %s" % _native.load_error())
    a = np.zeros(8, dtype=np.uint8)
    with pytest.raises(ValueError):
        _native.copy_bytes(a, np.zeros(7, dtype=np.uint8))
    with pytest.raises(TypeError):
        _native.copy_bytes(a.view(np.int64), a.view(np.int64))
    with pytest.raises(TypeError):
        _native.copy_bytes(np.zeros(16, dtype=np.uint8)[::2], a)
    ro = np.zeros(8, dtype=np.uint8)
    ro.flags.writeable = False
    with pytest.raises(ValueError):
        _native.copy_bytes(ro, a)


def _counts(nU=70, nI=50, nnz=1500, seed=2):
    rng = np.random.default_rng(seed)
    X = coo_array((rng.poisson(2, nnz) + 1.0, (rng.integers(nU, size=nnz),
                                               rng.integers(nI, size=nnz))), shape=(nU, nI))
    X.sum_duplicates()
    return X


@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("keep_all_objs", [True, False])
def test_a_fits_factors_are_the_hosts_quotient(use_float, keep_all_objs):
    """Theta and Beta, divided where the state is, are the bits of the
    host's division of the fitted state; the fit counts what it copied
    back (the state only where it is kept) and stages nothing on the CPU;
    the kept arrays are the model's own, frozen and thawable."""
    m = HPF(k=4, maxiter=6, check_every=3, stop_crit="train-llk", random_seed=2,
            use_float=use_float, keep_all_objs=keep_all_objs, verbose=False,
            device="cpu").fit(_counts())
    st = m.fit_stats_
    assert st.staged_bytes == 0
    if keep_all_objs:
        assert m.Theta.tobytes() == (m.Gamma_shp / m.Gamma_rte).tobytes()
        assert m.Beta.tobytes() == (m.Lambda_shp / m.Lambda_rte).tobytes()
        state = [getattr(m, name) for name in HPF._STATE_ATTRS]
        for a in state:
            assert a.flags.owndata and not a.flags.writeable
            a.flags.writeable = True
    else:
        state = []
        assert all(getattr(m, name, None) is None for name in HPF._STATE_ATTRS)
    assert m.Theta.dtype == (np.float32 if use_float else np.float64)
    assert st.bytes_to_host == sum(a.nbytes for a in [m.Theta, m.Beta, *state, m.seen])


def test_to_host_fills_arrays_made_ready_and_owns_them():
    """``HostArrays`` made ahead (allocated and touched on their thread):
    ``to_host`` fills the one of each tensor's shape and dtype, and
    allocates where none is left."""
    from hpfrec_tpu_torch.ops.staging import HostArrays

    t = _tensor(600, torch.float32).view(20, 30)
    u = _tensor(50, torch.int32)
    ready = HostArrays([((20, 30), np.float32), ((50,), np.int32), ((7,), np.int64)])
    a, b, c = to_host([t, u, t], ready, _chunk_bytes=CHUNK)
    for x, ref in ((a, t), (b, u), (c, t)):
        assert x.tobytes() == ref.numpy().tobytes() and x.flags.owndata
        x.flags.writeable = False
        x.flags.writeable = True
    assert not np.shares_memory(a, c)
    assert ready.take((7,), np.int64).shape == (7,) and ready.take((7,), np.int64) is None


@pytest.mark.parametrize("n,block", [(0, 4096), (1, 4096), (4097, 4096), (3 * 4096 + 5, 4096),
                                     (20_000, 1 << 21)])
def test_native_touch_pages_writes_a_zero_every_page(n, block):
    if not _native.available():
        pytest.skip("native helpers unavailable: %s" % _native.load_error())
    a = np.full(n, 0xCD, dtype=np.uint8)
    _native.touch_pages(a, block)
    want = np.full(n, 0xCD, dtype=np.uint8)
    want[::4096] = 0
    assert a.tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", [dict(), dict(keep_all_objs=False), dict(keep_data=False),
                                  dict(users_per_batch=20, use_float=False)],
                         ids=["full", "no_state", "no_seen", "svi_float64"])
def test_result_specs_name_every_array_a_fit_copies_back(mode):
    """What a card fit makes ready during its loop is what it copies back:
    Theta, Beta, the state where kept, the seen CSR's entries where kept,
    shape for shape and dtype for dtype."""
    m = HPF(k=4, maxiter=6, check_every=3, stop_crit="train-llk", random_seed=2,
            verbose=False, device="cpu", **mode)
    X = _counts()
    m.fit(X)
    back = [m.Theta, m.Beta]
    if m.keep_all_objs:
        back += [getattr(m, name) for name in HPF._STATE_ATTRS]
    if getattr(m, "seen", None) is not None:
        back.append(m.seen)
    assert sorted((a.shape, str(a.dtype)) for a in back) == sorted(
        (tuple(s), str(np.dtype(d))) for s, d in m._result_specs(m.fit_stats_.nnz,
                                                                 "users_per_batch" in mode))
