"""Data-parallel fits of hpfrec_tpu_torch (``parallel/``, K12) on the CPU.

- ``build_ell(pad_shards=...)`` packs the JAX package's layouts bit for bit.
- The local halves of K12a-c, called once for each rank in one process and
  then reassembled (ELL) or summed (COO, SVI), equal the whole layout's or
  stream's or batch's sums (float64, 1e-12: the plain versions add in
  other orders).
- Two processes over gloo (``init_method=file://``) fit the ELL and COO
  engines in full batch, alternating SVI with val-llk, and a
  ``partial_fit``: the ranks hold the same arrays bit for bit; the fit
  agrees with ``hpfrec_tpu.HPF(mesh=make_mesh(jax.devices()[:2]))``
  (float64 factors 1e-9, llk 1e-10, measured <= 9.9e-14 and 6.7e-16;
  float32, ELL, 10 iterations: factors 1e-4, measured 4.7e-5, and llk
  2e-6, measured 6.4e-7: each package's float32 digamma is ~1.3e-6 off
  and the iterations grow the gap, as in test_torch_ell.py), and with the
  port's one-device fit: the ELL fit bit for bit (the exchange copies
  segment sums, never adds them), its llk to 1e-12 (other K4 partial
  boundaries; measured 1.1e-16); COO, SVI and ``partial_fit`` 1e-11
  (measured <= 1.8e-14: the item sums are added over the ranks).
- ``distributed.initialize`` raises for an unreachable coordinator and a
  wrong process count, picks NCCL for a CUDA device unless gloo is named,
  and runs a rank on the CPU only where ``device="cpu"`` is named.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from oracle import synth_counts

REPO = str(Path(__file__).resolve().parents[1])
TESTS = str(Path(__file__).resolve().parent)
STATE = ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte", "k_rte",
         "t_rte")


@pytest.fixture(autouse=True)
def _restore_x64():
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _csr(y, iu, ii, n_rows, n_cols):
    from hpfrec_tpu_torch.utils.data import build_csr

    return build_csr(iu, ii, y, n_rows, n_cols)


# ---- host halves ------------------------------------------------------------

@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
@pytest.mark.parametrize("pad_shards", [2, 4])
def test_build_ell_pad_shards_identical_to_jax(pad_shards, tiled):
    from hpfrec_tpu.ops import ell as J
    from hpfrec_tpu_torch.ops import ell as T

    nU, nI = 150, 90
    y, iu, ii = synth_counts(nU, nI, nnz=3000, seed=5)
    indptr, ind, dat = _csr(y, iu, ii, nU, nI)
    kw = dict(max_width=16, pad_shards=pad_shards, n_cols=nI,
              col_chunk_rows=17 if tiled else None)
    lj = J.build_ell(indptr, ind, dat, nU, **kw)
    lt = T.build_ell(indptr, ind, dat, nU, **kw)
    assert len(lj.buckets) == len(lt.buckets)
    for bj, bt in zip(lj.buckets, lt.buckets):
        assert bt.rows.shape[0] % pad_shards == 0
        for a, b in zip(bj, bt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("inv_perm", "split_rows", "split_seg_pos"):
        np.testing.assert_array_equal(getattr(lj, name), getattr(lt, name))
    assert (lj.n_rows, lj.col_spans) == (lt.n_rows, lt.col_spans)
    assert lt.split_rows.shape[0] > 0  # split rows are remapped too


def test_share_cuts_runs_into_near_equal_parts():
    from hpfrec_tpu_torch.utils.data import share

    bounds = np.array([0, 5, 5, 9, 30, 31, 40, 41, 60])
    for n in (1, 2, 3, 5):
        cuts = [share(bounds, n, r) for r in range(n)]
        assert cuts[0][0] == 0 and cuts[-1][1] == len(bounds) - 1
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        # share j ends at the first run boundary at or after j/n of the positions
        for j, (_, i1) in enumerate(cuts[:-1]):
            assert bounds[i1] >= 60 * (j + 1) // n and bounds[i1 - 1] < 60 * (j + 1) // n


# ---- the local halves, every rank in one process -----------------------------

def _tables(nU, nI, k, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((nU, k)) + 0.1),
            torch.from_numpy(rng.random((nI, k)) + 0.1))


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
@pytest.mark.parametrize("n_ranks", [2, 3])
def test_ell_local_halves_reassemble_to_the_whole(n_ranks, tiled):
    from hpfrec_tpu_torch.ops import ell as E

    nU, nI, k = 150, 90, 5
    y, iu, ii = synth_counts(nU, nI, nnz=3000, seed=5, dtype=np.float64)
    t_tab, b_tab = _tables(nU, nI, k, 1)
    for rows, cols, n_r, n_c, ts, to in ((iu, ii, nU, nI, t_tab, b_tab),
                                         (ii, iu, nI, nU, b_tab, t_tab)):
        indptr, ind, dat = _csr(y, rows, cols, n_r, n_c)
        kw = dict(max_width=16, dtype=np.float64, n_cols=n_c,
                  col_chunk_rows=17 if tiled else None)
        whole = E.ell_phi_sums(ts, to, E.to_device(E.build_ell(indptr, ind, dat, n_r, **kw),
                                                   "cpu"))
        host = E.build_ell(indptr, ind, dat, n_r, pad_shards=n_ranks, **kw)
        shards = [E.to_device(host, "cpu", (r, n_ranks)) for r in range(n_ranks)]
        seg = torch.cat([E.all_bucket_sums(ts, to, s) for s in shards])
        got = E.segment_table_sums(seg, shards[0])
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-12)


def _pdata(nU=70, nI=50, nnz=900, seed=8):
    from hpfrec_tpu_torch.utils.data import process_data

    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed, dtype=np.float64)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    return process_data(df, "train-llk", False, np.float64, sort_by_user=True)


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_coo_local_halves_sum_to_the_whole(n_ranks):
    from hpfrec_tpu_torch.ops import cavi as C

    from hpfrec_tpu_torch.ops.ingest import Csr
    from hpfrec_tpu_torch.utils.data import build_csr

    pdata = _pdata()
    indptr, cols, vals = build_csr(pdata.ix_u, pdata.ix_i, pdata.y, pdata.nusers, pdata.nitems)
    user = Csr(indptr, torch.from_numpy(cols), torch.from_numpy(vals),
               torch.from_numpy(indptr.astype(np.int32)))
    t_tab, b_tab = _tables(pdata.nusers, pdata.nitems, 4, 2)
    su, si = C.coo_phi_sums(t_tab, b_tab, C.coo_stream(user, pdata.nitems))
    parts = [C.coo_stream(user, pdata.nitems, block_size=64, shard=(r, n_ranks))
             for r in range(n_ranks)]
    assert sum(p.nnz for p in parts) == pdata.y.shape[0]
    assert max(p.nnz for p in parts) - min(p.nnz for p in parts) < 60  # near-equal
    sums = [C.coo_phi_sums(t_tab, b_tab, p) for p in parts]
    np.testing.assert_allclose(sum(s[0] for s in sums).numpy(), su.numpy(), rtol=1e-12)
    np.testing.assert_allclose(sum(s[1] for s in sums).numpy(), si.numpy(), rtol=1e-12)


@pytest.mark.parametrize("user_side", [True, False], ids=["users", "items"])
@pytest.mark.parametrize("n_ranks", [2, 3])
def test_svi_local_halves_sum_to_the_whole(n_ranks, user_side):
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.utils.data import share

    pdata = _pdata()
    rows, cols, n_r, n_c = ((pdata.ix_u, pdata.ix_i, pdata.nusers, pdata.nitems) if user_side
                            else (pdata.ix_i, pdata.ix_u, pdata.nitems, pdata.nusers))
    t_loc, t_oth = _tables(n_r, n_c, 4, 3)
    side = S.epoch_side(*_csr(pdata.y, rows, cols, n_r, n_c), np.float64, "cpu")
    perm = np.random.default_rng(4).permutation(n_r)
    off_h = S.epoch_offsets(side.deg, perm)
    perm_d, off_d = (torch.from_numpy(a.astype(np.int32)) for a in (perm, off_h))
    e_y, e_row, e_col = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, off_d)
    r0, r1 = 7, 7 + n_r // 3
    s, e = int(off_h[r0]), int(off_h[r1])
    s_loc, s_oth, omask = S.batch_phi_sums(t_loc, t_oth, e_y[s:e], e_row[s:e], e_col[s:e],
                                           off_d[r0:r1 + 1], s, perm_d[r0:r1])

    def local_half(rank):  # the share that ops.svi cuts for K12b
        q0, q1 = (r0 + q for q in share(off_h[r0:r1 + 1], n_ranks, rank))
        a, b = int(off_h[q0]), int(off_h[q1])
        return S.batch_phi_sums(t_loc, t_oth, e_y[a:b], e_row[a:b], e_col[a:b],
                                off_d[q0:q1 + 1], a, perm_d[q0:q1])

    parts = [local_half(r) for r in range(n_ranks)]
    assert all(p[2].any() for p in parts)  # every rank has rows of the batch
    np.testing.assert_allclose(sum(p[0] for p in parts).numpy(), s_loc.numpy(), rtol=1e-12)
    np.testing.assert_allclose(sum(p[1] for p in parts).numpy(), s_oth.numpy(), rtol=1e-12)
    got_mask = parts[0][2].clone()
    for p in parts[1:]:
        got_mask |= p[2]
    assert torch.equal(got_mask, omask)


# ---- two-process fits over gloo --------------------------------------------

def _data(dtype):
    y, iu, ii = synth_counts(83, 45, nnz=800, seed=5, dtype=dtype)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


BASE = dict(k=6, maxiter=10, check_every=5, stop_crit="train-llk", stop_thr=1e-10,
            random_seed=3, verbose=False)
MODES = {
    "ell": dict(),
    "coo": dict(engine="coo"),
    "svi": dict(users_per_batch=24, items_per_batch=13, stop_crit="val-llk", check_every=2,
                maxiter=6),
    "partial_fit": dict(reindex=False, maxiter=4, check_every=2),
    # no seed: rank 0 draws one and every rank uses it (engine.agreed_seed)
    "unseeded": dict(random_seed=None, maxiter=4, check_every=2),
}


def _recording(cls):
    class Recording(cls):
        def _evaluate_criterion(self, *a, **k):
            out = super()._evaluate_criterion(*a, **k)
            self.llk_trace.append(self._last_llk)
            return out

    return Recording


def _fit(cls, mode, dtype, **extra):
    """One mode's fit with the HPF class ``cls`` (either package):
    {state arrays..., llk: the llk at every check, niter}."""
    df = _data(dtype)
    kw = dict(BASE, use_float=dtype == np.float32, **MODES[mode])
    m = _recording(cls)(**kw, **extra)
    m.llk_trace = []
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="When using 'partial_fit'")
        if mode == "svi":
            hold = np.random.default_rng(1).random(len(df)) < 0.15
            m.fit(df[~hold].copy(), val_set=df[hold].copy())
        else:
            m.fit(df.copy())
        if mode == "partial_fit":
            batch = df[df.UserId < 30].copy()
            m.partial_fit(batch)
            m.partial_fit(df[df.ItemId < 20].copy(), batch_type="items")
    out = {name: np.array(getattr(m, name)) for name in STATE}
    out.update(llk=np.array(m.llk_trace, dtype=np.float64), niter=np.array(m.niter))
    return out


def _port_fit(mode, dtype, mesh=None):
    from hpfrec_tpu_torch import HPF

    return _fit(HPF, mode, dtype, device="cpu", mesh=mesh)


def _jax_fit(mode, dtype, n_dev):
    import jax

    from hpfrec_tpu import HPF
    from hpfrec_tpu.parallel import make_mesh

    jax.config.update("jax_enable_x64", dtype == np.float64)
    return _fit(HPF, mode, dtype, mesh=make_mesh(jax.devices()[:n_dev]))


WORKER = """
import sys
sys.path[:0] = [{tests!r}, {repo!r}]
import numpy as np
from hpfrec_tpu_torch.parallel import distributed
rank, init, out, mode, dtype = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
mesh = distributed.initialize(init, num_processes=2, process_id=rank,
                              initialization_timeout=60, device="cpu")
assert (mesh.world_size, mesh.rank, mesh.backend, mesh.device.type) == (2, rank, "gloo", "cpu")
import importlib
T = importlib.import_module({module!r})
np.savez(out % rank, **T._port_fit(mode, np.dtype(dtype).type, mesh))
import torch.distributed as dist
dist.destroy_process_group()
"""


def _two_ranks(tmp_path, mode, dtype, module="test_torch_parallel"):
    """Two gloo CPU ranks, each a process running ``module._port_fit(mode,
    dtype, mesh)``; returns each rank's arrays."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(tests=TESTS, repo=REPO, module=module))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = str(tmp_path / "out_%d.npz")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r),
                               "file://" + str(tmp_path / "rendezvous"), out, mode,
                               np.dtype(dtype).name],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(out % r)) for r in (0, 1)]


TWO_RANK_CASES = [("ell", np.float64), ("ell", np.float32), ("coo", np.float64),
                  ("svi", np.float64), ("partial_fit", np.float64)]
JAX_TOL = {np.float64: dict(factors=1e-9, llk=1e-10), np.float32: dict(factors=1e-4, llk=2e-6)}


@pytest.mark.parametrize("mode,dtype", TWO_RANK_CASES,
                         ids=[f"{m}-{np.dtype(d).name}" for m, d in TWO_RANK_CASES])
def test_two_rank_gloo_fit(tmp_path, mode, dtype):
    r0, r1 = _two_ranks(tmp_path, mode, dtype)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)  # ranks bit-equal

    one = _port_fit(mode, dtype)
    assert int(r0["niter"]) == int(one["niter"])
    if mode == "ell":
        for name in STATE:
            np.testing.assert_array_equal(r0[name], one[name], err_msg=name)
        np.testing.assert_allclose(r0["llk"], one["llk"], rtol=1e-12)
    else:
        for name in (*STATE, "llk"):
            np.testing.assert_allclose(r0[name], one[name], rtol=1e-11, err_msg=name)

    ref = _jax_fit(mode, dtype, 2)
    tol = JAX_TOL[dtype]
    assert int(r0["niter"]) == int(ref["niter"])
    if mode != "partial_fit":
        assert len(r0["llk"]) > 0
    np.testing.assert_allclose(r0["llk"], ref["llk"], rtol=tol["llk"])
    for name in STATE:
        np.testing.assert_allclose(r0[name], ref[name], rtol=tol["factors"], err_msg=name)


def test_two_rank_unseeded_fit_agrees_across_ranks(tmp_path):
    """Without a seed each process would draw its own init and shuffles;
    the ranks share rank 0's draw instead."""
    r0, r1 = _two_ranks(tmp_path, "unseeded", np.float64)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    assert np.all(np.isfinite(r0["llk"])) and len(r0["llk"]) == 2


# ---- initialize -------------------------------------------------------------

BAD_COORDINATOR_WORKER = """
import sys
sys.path.insert(0, {repo!r})
from hpfrec_tpu_torch.parallel import distributed
try:
    distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                           process_id=1, initialization_timeout=2, device="cpu")
except RuntimeError as e:
    print("RAISED_AS_EXPECTED:", str(e)[:200])
    sys.exit(0)
print("DID_NOT_RAISE")
sys.exit(1)
"""


def test_bad_coordinator_raises_instead_of_silent_single_process(tmp_path):
    """A misconfigured multi-process job fails loudly instead of training
    alone (the port of tests/test_distributed.py's case)."""
    worker = tmp_path / "bad.py"
    worker.write_text(BAD_COORDINATOR_WORKER.format(repo=REPO))
    p = subprocess.run([sys.executable, str(worker)], capture_output=True, timeout=90)
    out = p.stdout.decode() + p.stderr.decode()
    assert p.returncode == 0 and "RAISED_AS_EXPECTED" in out, out[-3000:]
    assert "init_process_group failed for coordinator '127.0.0.1:1'" in out


WRONG_COUNT_WORKER = """
import sys, warnings
sys.path.insert(0, {repo!r})
from hpfrec_tpu_torch.parallel import distributed
mesh = distributed.initialize({init!r}, num_processes=1, process_id=0, device="cpu")
assert (mesh.world_size, mesh.rank) == (1, 0)
try:
    distributed.initialize({init!r}, num_processes=2, process_id=0, device="cpu")
except RuntimeError as e:
    assert "refusing to train on a partial mesh" in str(e), e
    print("RAISED_AS_EXPECTED")
"""


def test_wrong_num_processes_raises(tmp_path):
    worker = tmp_path / "count.py"
    worker.write_text(WRONG_COUNT_WORKER.format(repo=REPO,
                                                init="file://" + str(tmp_path / "rdv")))
    p = subprocess.run([sys.executable, str(worker)], capture_output=True, timeout=90)
    out = p.stdout.decode() + p.stderr.decode()
    assert p.returncode == 0 and "RAISED_AS_EXPECTED" in out, out[-3000:]


@pytest.mark.parametrize("device,backend,want", [
    (None, None, ("cuda:1", "nccl")),
    ("cuda", None, ("cuda:1", "nccl")),
    ("cuda:0", "gloo", ("cuda:0", "gloo")),
    (None, "gloo", ("cuda:1", "gloo")),
    ("cpu", None, ("cpu", "gloo")),
])
def test_backend_is_nccl_on_a_card_unless_gloo_is_named(monkeypatch, device, backend, want):
    from hpfrec_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    dev, got = distributed._device_and_backend(device, backend, 3)
    assert (str(dev), got) == want


@pytest.mark.parametrize("backend", [None, "gloo", "nccl"])
def test_no_cuda_without_a_named_cpu_device_raises(monkeypatch, backend):
    """A mesh runs on the CPU only where the caller names it: without
    ``device`` and without CUDA, setting up a rank raises."""
    from hpfrec_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed._device_and_backend(None, backend, 0)
    assert distributed._device_and_backend("cpu", None, 0) == (torch.device("cpu"), "gloo")


def test_nccl_on_the_cpu_raises():
    from hpfrec_tpu_torch.parallel import distributed

    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        distributed._device_and_backend("cpu", "nccl", 0)


def test_make_mesh_needs_a_process_group():
    from hpfrec_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()


def test_shard_tables_in_svi_mode_warns_and_fits():
    from hpfrec_tpu_torch import HPF

    m = HPF(k=4, maxiter=2, check_every=1, users_per_batch=20, shard_tables=True,
            verbose=False, device="cpu")
    with pytest.warns(UserWarning, match="shard_tables=True is ignored in mini-batch SVI"):
        m.fit(_data(np.float32))
    assert m.is_fitted


@pytest.mark.parametrize("rank", [0, 1])
def test_save_is_written_by_rank0_behind_a_barrier(tmp_path, monkeypatch, rank):
    """Every rank of a mesh calls ``save``; rank 0 writes the files and
    every rank waits at the barrier (no two processes write one file)."""
    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.parallel import Mesh, engine

    m = HPF(k=3, maxiter=2, check_every=2, verbose=False, device="cpu").fit(_data(np.float64))
    waits = []
    monkeypatch.setattr(engine, "barrier", waits.append)
    m.mesh = Mesh(group=None, world_size=2, rank=rank, device=torch.device("cpu"))
    m.save(str(tmp_path / "model"))
    assert waits == [m.mesh]
    assert (tmp_path / "model" / "model.npz").exists() == (rank == 0)
