"""The table-sharded engine of hpfrec_tpu_torch (``parallel/table_sharded.py``,
K13) on the CPU.

- The host half builds the JAX package's plans, balanced permutations and
  sharded layouts bit for bit, for 2 and 4 ranks, balanced and contiguous,
  with the 40 MB sub-tile window and with a window of 4 rows (several
  sub-tiles a shard) and split rows.
- Each rank's half of K13a (K1 per ring offset, then K2) and of K13c (K4
  per ring offset), run for every rank in one process with the ring's
  shards handed in, equals the one-device E-step and train-llk partials
  (float64, 1e-12: the sums run in other orders); padding rows come out
  exactly 0.
- K3's pad-row form: the real rows as the plain update gives them, the
  padding rows' scaler 0, mean and exp table +0.0, the colsum that of the
  real rows.
- Two processes over gloo (``init_method=file://``) fit with
  ``shard_tables=True``: the ranks hold the same arrays bit for bit, and
  the fit agrees with ``hpfrec_tpu.HPF(mesh=make_mesh(jax.devices()[:2]),
  shard_tables=True)``: float64 factors 1e-9 and llk 1e-10 (measured
  9.0e-14 and 7.8e-16; JAX's own table-sharded fit is within 1.8e-14 of
  its one-device fit), float32 factors 1e-4 and llk 2e-6 (measured 4.5e-5
  and 4.3e-7; test_torch_parallel.py's ``JAX_TOL``: each package's float32
  digamma is ~1.3e-6 off); a fit with bfloat16 exp tables
  (``gather_dtype='bfloat16'``, the ring carrying bfloat16 shards) against
  JAX's with the same gather dtype at the float32 limits (measured factors
  7.2e-7, llk 1.3e-7); a diff-norm fit's norms to 1e-10 (measured
  4.0e-15).  A fit checkpointed at iteration 5 writes the real rows only, the
  same arrays as that fit ends with, and resumed to 10 it equals the
  uninterrupted fit.  A val-llk fit is held against JAX's fit WITHOUT table
  sharding (measured 2.9e-15): JAX's table-sharded val-llk reads its
  padded, permuted rows by the original ids (JAX ``hpf.py:801-805``), and
  the test shows that JAX figure off by more than 1e-3 (-325.3 / -359.4
  against -313.6 / -368.0).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from oracle import synth_counts
from test_torch_parallel import STATE, _two_ranks


@pytest.fixture(autouse=True)
def _restore_x64():
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _csr(y, rows, cols, n_rows, n_cols):
    from hpfrec_tpu_torch.utils.data import build_csr

    return build_csr(rows, cols, y, n_rows, n_cols)


def _head_counts(dtype=np.float32):
    """83 x 45 counts where every user has item 0, so that item 0's row
    splits at ``max_width=16``."""
    y, iu, ii = synth_counts(83, 45, nnz=1100, seed=5, dtype=dtype)
    key = np.unique(np.concatenate([iu.astype(np.int64) * 45 + ii, np.arange(83) * 45]))
    y = np.random.default_rng(2).poisson(2.0, len(key)).astype(dtype) + 1
    return y, (key // 45).astype(np.int32), (key % 45).astype(np.int32)


def _both_csr(dtype):
    y, iu, ii = _head_counts(dtype)
    return _csr(y, iu, ii, 83, 45), _csr(y, ii, iu, 45, 83)


SMALL_WINDOW = 4 * 6 * 4  # bytes: 4 rows of a k=6 float32 table, so several sub-tiles


# ---- the host half ---------------------------------------------------------------

@pytest.mark.parametrize("window", ["40MB", "4 rows"])
@pytest.mark.parametrize("balance", [True, False], ids=["balanced", "contiguous"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_layouts_identical_to_jax(monkeypatch, ndev, balance, window):
    from hpfrec_tpu.parallel import table_sharded as J
    from hpfrec_tpu_torch.parallel import table_sharded as T

    if window == "4 rows":
        monkeypatch.setattr(J, "FAST_GATHER_BYTES", SMALL_WINDOW)
        monkeypatch.setattr(T, "_FAST_GATHER_BYTES", SMALL_WINDOW)
    csr_u, csr_i = _both_csr(np.float32)
    args = (*csr_u, *csr_i, 83, 45, 6, ndev, 4)
    pj = J.prepare_table_sharded(*args, dtype=np.float32, balance=balance, max_width=16)
    pt = T.prepare_table_sharded(*args, dtype=np.float32, balance=balance, max_width=16)
    for got, want in zip(pt[2:], pj[2:]):  # plans and permutations
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for st, sj in zip(pt[:2], pj[:2]):
        assert (st.rows_per_dev, st.bucket_meta, st.per_opp) == (
            sj.rows_per_dev, sj.bucket_meta, sj.per_opp)
        assert len(st.buckets) == len(sj.buckets)
        for bt, bj in zip(st.buckets, sj.buckets):
            for a, b in zip(bt, bj):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for name in ("inv_perm", "split_rows", "split_seg_pos"):
            np.testing.assert_array_equal(getattr(st, name), getattr(sj, name))
    meta_u = pt.se_u.bucket_meta
    assert any(o > 0 for o, _, _ in meta_u)  # the ring is used
    assert (len({m[1:] for m in meta_u}) > 1) == (window == "4 rows")  # sub-tiles
    assert (pt.se_i.split_seg_pos < pt.se_i.split_seg_pos.max()).any()  # split rows


# ---- each rank's half, every rank in one process ---------------------------------

def _padded(real, slot, n_padded):
    """A table in the padded, permuted order of all ranks: real row r at
    ``slot[r]``, padding rows 0 (as the engine keeps them)."""
    out = torch.zeros((n_padded, real.shape[1]), dtype=real.dtype)
    out[torch.from_numpy(slot)] = real
    return out


@pytest.mark.parametrize("ndev", [2, 3])
def test_rank_halves_match_the_one_device_sums(monkeypatch, ndev):
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.parallel import table_sharded as T

    monkeypatch.setattr(T, "_FAST_GATHER_BYTES", SMALL_WINDOW)
    csr_u, csr_i = _both_csr(np.float64)
    plan = T.prepare_table_sharded(*csr_u, *csr_i, 83, 45, 6, ndev, 4, dtype=np.float64,
                                   max_width=16)
    rng = np.random.default_rng(7)
    t_real, b_real = (torch.from_numpy(rng.random((n, 6)) + 0.1) for n in (83, 45))
    slot_u, slot_i = (np.argsort(p, kind="stable")[:n]
                      for p, n in ((plan.perm_u, 83), (plan.perm_i, 45)))
    t_pad, b_pad = _padded(t_real, slot_u, plan.plan_u[0]), _padded(b_real, slot_i, plan.plan_i[0])
    sides = ((plan.se_u, plan.perm_u, 83, t_pad, b_pad, csr_u, slot_u, t_real, b_real),
             (plan.se_i, plan.perm_i, 45, b_pad, t_pad, csr_i, slot_i, b_real, t_real))
    for se, perm, n, mine, opp, csr, slot, s_real, o_real in sides:
        per, per_opp = se.rows_per_dev, se.per_opp
        shares = [T.rank_share(se, d, "cpu", perm, n) for d in range(ndev)]
        assert sum(s.n_real for s in shares) == n
        got = torch.cat([
            T.ring_table_sums(None, mine[d * per:(d + 1) * per], None, shares[d],
                              shards=[opp[e * per_opp:(e + 1) * per_opp]
                                      for e in ((d - o) % ndev for o in range(ndev))])
            for d in range(ndev)])
        whole = E.ell_phi_sums(s_real, o_real, E.to_device(
            E.build_ell(*csr, n, max_width=16, dtype=np.float64), "cpu"))
        np.testing.assert_allclose(got[torch.from_numpy(slot)].numpy(), whole.numpy(),
                                   rtol=1e-12)
        pad = np.setdiff1d(np.arange(got.shape[0]), slot)
        assert torch.equal(got[pad], torch.zeros_like(got[pad]))

    # K13c: the users' llk partials against the one-device layout's
    per_u, per_i = plan.se_u.rows_per_dev, plan.se_i.rows_per_dev
    parts = torch.cat([
        T.table_sharded_llk_parts(None, t_pad[d * per_u:(d + 1) * per_u],
                                  None, T.rank_share(plan.se_u, d, "cpu"), False,
                                  shards=[b_pad[e * per_i:(e + 1) * per_i]
                                          for e in ((d - o) % ndev for o in range(ndev))])
        for d in range(ndev)])
    whole = M.ell_llk_rmse_sums(t_real, b_real, E.to_device(
        E.build_ell(*csr_u, 83, max_width=16, dtype=np.float64), "cpu"))
    np.testing.assert_allclose(parts.sum(0).numpy(), whole.sum(0).numpy(), rtol=1e-12)


def test_padding_rows_must_be_a_tail():
    from hpfrec_tpu_torch.parallel import table_sharded as T

    csr_u, csr_i = _both_csr(np.float32)
    plan = T.prepare_table_sharded(*csr_u, *csr_i, 83, 45, 6, 2, 4)
    perm = plan.perm_u.copy()
    per = plan.se_u.rows_per_dev
    pad = int(np.flatnonzero(perm >= 83)[0])
    perm[[pad, pad - (pad % per)]] = perm[[pad - (pad % per), pad]]  # a padding row first
    with pytest.raises(AssertionError, match="not the tail"):
        T.rank_share(plan.se_u, pad // per, "cpu", perm, 83)


@pytest.mark.parametrize("tab_dtype", [None, torch.bfloat16], ids=["state", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pad_row_form_of_the_table_update(dtype, tab_dtype):
    """Real rows as the plain update gives them; padding rows (entering
    with sums 0 and scaler 0) write scaler 0, rate +inf and a mean and exp
    table of exactly +0.0."""
    from hpfrec_tpu_torch.ops import cavi as C

    n, k, n_real = 40, 6, 33
    rng = np.random.default_rng(3)
    sums = torch.from_numpy(rng.random((n, k)) * 30).to(dtype)
    scaler = torch.from_numpy(rng.random((n, 1)) + 1).to(dtype)
    colsum = torch.from_numpy(rng.random((1, k)) * 100).to(dtype)
    sums[n_real:], scaler[n_real:] = 0, 0
    args = (0.3, 0.3 + k * 0.3, 0.3, tab_dtype)
    got = C.side_update(sums, scaler, colsum, *args, n_real=n_real)
    ref = C.side_update(sums[:n_real], scaler[:n_real], colsum, *args)
    for g, r in zip(got[:4], ref[:4]):
        assert torch.equal(g[:n_real], r)
    torch.testing.assert_close(got[4], ref[4], rtol=1e-15, atol=0)
    shp, rte, tab, scaler_new, _ = got
    mean = shp[n_real:] / rte[n_real:]
    assert torch.isinf(rte[n_real:]).all() and torch.equal(scaler_new[n_real:],
                                                          torch.zeros_like(scaler_new[n_real:]))
    for zero in (mean, tab[n_real:]):
        assert (zero == 0).all() and not torch.signbit(zero).any()
    with pytest.raises(ValueError, match="n_real"):
        C.side_update(sums, scaler, colsum, *args, n_real=n + 1)


# ---- two-process fits over gloo --------------------------------------------------

def _data(dtype):
    y, iu, ii = synth_counts(83, 45, nnz=800, seed=5, dtype=dtype)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


BASE = dict(k=6, maxiter=10, check_every=5, stop_crit="train-llk", stop_thr=1e-10,
            random_seed=3, verbose=False, shard_tables=True)
MODES = {
    "train": dict(),
    "val": dict(stop_crit="val-llk"),
    "diffnorm": dict(stop_crit="diff-norm"),
    # checkpointed at iteration 5, then resumed to 10
    "resume": dict(checkpoint_every=5),
    # the exp tables in bfloat16, on the ring too
    "bf16": dict(gather_dtype="bfloat16"),
}
CKPT_ENV = "HPF_TS_TEST_CHECKPOINTS"


def _recording(cls):
    """``cls`` recording the criterion of every check: the llk, or the
    diff-norm criterion's norm."""
    class Recording(cls):
        def _evaluate_criterion(self, *a, **k):
            out = super()._evaluate_criterion(*a, **k)
            self.trace.append(out[1] if self.stop_crit == "diff-norm" else self._last_llk)
            return out

    return Recording


def _fit(cls, mode, dtype, **extra):
    """One mode's fit with the HPF class ``cls`` (either package): {state
    arrays..., llk: the criterion at every check, niter}.  "resume" fits 5
    iterations with a checkpoint at 5 and resumes to 10; it also returns
    the first fit's arrays (``first_*``), its checkpoint's (``ckpt_*``) and
    those of a fit of 10 iterations in one go (``whole_*``)."""
    df = _data(dtype)
    hold = np.random.default_rng(1).random(len(df)) < 0.15
    kw = dict(BASE, use_float=dtype == np.float32, **MODES[mode], **extra)

    def run(resume=False, **more):
        m = _recording(cls)(**dict(kw, **more))
        m.trace = []
        if mode == "val":
            m.fit(df[~hold].copy(), val_set=df[hold].copy())
        else:
            m.fit(df.copy(), resume=resume)
        return m

    def arrays(m, prefix=""):
        return {prefix + name: np.array(getattr(m, name)) for name in STATE}

    out = {}
    if mode == "resume":
        from hpfrec_tpu_torch.utils.io import load_checkpoint

        folder = os.environ[CKPT_ENV]
        out.update(arrays(run(maxiter=5, checkpoint_folder=folder), "first_"))
        ck, meta, _ = load_checkpoint(folder)
        out.update({"ckpt_" + n: a for n, a in zip(STATE[2:], ck)}, ckpt_niter=meta["niter"])
        m = run(resume=True, checkpoint_folder=folder)
        out.update(arrays(run(checkpoint_every=None), "whole_"))
    else:
        m = run()
    out.update(arrays(m), llk=np.array(m.trace, dtype=np.float64), niter=np.array(m.niter))
    return out


def _port_fit(mode, dtype, mesh=None):
    from hpfrec_tpu_torch import HPF

    return _fit(HPF, mode, dtype, device="cpu", mesh=mesh)


def _jax_fit(mode, dtype, shard_tables=True):
    import jax

    from hpfrec_tpu import HPF
    from hpfrec_tpu.parallel import make_mesh

    jax.config.update("jax_enable_x64", dtype == np.float64)
    return _fit(HPF, mode, dtype, mesh=make_mesh(jax.devices()[:2]), shard_tables=shard_tables)


TS_CASES = [("train", np.float64), ("train", np.float32), ("diffnorm", np.float64),
            ("val", np.float64), ("resume", np.float64), ("bf16", np.float32)]
JAX_TOL = {np.float64: dict(factors=1e-9, llk=1e-10), np.float32: dict(factors=1e-4, llk=2e-6)}


@pytest.mark.parametrize("mode,dtype", TS_CASES,
                         ids=[f"{m}-{np.dtype(d).name}" for m, d in TS_CASES])
def test_two_rank_table_sharded_fit(tmp_path, monkeypatch, mode, dtype):
    monkeypatch.setenv(CKPT_ENV, str(tmp_path / "ck"))
    r0, r1 = _two_ranks(tmp_path, mode, dtype, module="test_torch_table_sharded")
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)  # ranks bit-equal
    assert r0["Theta"].shape == (83, 6) and r0["Beta"].shape == (45, 6)  # real rows only
    assert len(r0["llk"]) == (1 if mode == "resume" else 2)  # resumed at iteration 5
    assert np.all(np.isfinite(r0["llk"]))

    tol = JAX_TOL[dtype]
    ref = _jax_fit(mode, dtype, shard_tables=mode != "val")
    assert int(r0["niter"]) == int(ref["niter"])
    np.testing.assert_allclose(r0["llk"], ref["llk"], rtol=tol["llk"])
    for name in STATE:
        np.testing.assert_allclose(r0[name], ref[name], rtol=tol["factors"], err_msg=name)
    if mode == "val":
        jax_ts = _jax_fit(mode, dtype)
        assert np.abs(jax_ts["llk"] / r0["llk"] - 1).max() > 1e-3
    if mode == "resume":  # real rows only in the checkpoint; the resumed fit as one fit
        assert int(r0["ckpt_niter"]) == 5
        for name in STATE[2:]:
            np.testing.assert_array_equal(r0["ckpt_" + name], r0["first_" + name],
                                          err_msg=name)
        for name in STATE:
            np.testing.assert_array_equal(r0[name], r0["whole_" + name], err_msg=name)
