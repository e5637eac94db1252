"""The ``HPF`` model class on PyTorch: full-batch CAVI and mini-batch SVI
on one device.

Port of ``hpfrec_tpu/models/hpf.py`` (itself API-compatible with the
reference ``hpfrec/__init__.py:11-1459``): the constructor with all of the
reference's arguments and their validation; ``fit`` in full-batch CAVI on
the bucketed-ELL engine or in mini-batch SVI (``users_per_batch`` /
``items_per_batch``), with all four stopping criteria and a validation
set; ``eval_llk``; and ``predict`` / ``topN`` on the fitted host factors.
The device loops run the hand-written CUDA kernels of
``hpfrec_tpu_torch/csrc`` on a CUDA device, and their plain PyTorch
versions on the CPU.

One keyword-only argument is new: ``device`` (default ``"cuda"``), where
the JAX class has ``mesh``.  With ``device="cuda"`` and no CUDA, ``fit``
raises; nothing falls back to the CPU.

Options and methods of the JAX class that are not ported yet raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.  Fixed (seed,
dtype, device) gives bit-identical runs: no kernel uses atomics.
"""

from __future__ import annotations

import inspect
import os
import time
import types
import warnings

import numpy as np
import torch

from ..utils import data as data_utils
from .state import Hyperparams, VariationalState, initialize_state


def _as_float(x, name):
    if isinstance(x, int):
        x = float(x)
    assert isinstance(x, float), f"'{name}' must be a number"
    return x


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to hpfrec_tpu_torch yet "
        f"(ROADMAP.md, Queue 1 item {item}); use hpfrec_tpu for it")


class HPF:
    """Hierarchical Poisson Factorization, fit by full-batch CAVI or
    mini-batch SVI on one PyTorch device.

    The constructor signature and defaults match ``hpfrec_tpu.HPF`` and the
    reference ``HPF`` (``hpfrec/__init__.py:205-358``); see
    ``hpfrec_tpu.models.hpf.HPF`` for every parameter.  Differences:

    device : str or torch.device, keyword-only, default ``"cuda"``
        Where the iterations run.  ``"cuda"`` launches the port's CUDA
        kernels and raises in ``fit`` when CUDA is absent; ``"cpu"`` runs
        the kernels' plain PyTorch versions.

    Not ported yet (raise ``NotImplementedError``): ``engine='coo'``,
    ``shard_tables``, ``mesh``, ``checkpoint_folder`` /
    ``checkpoint_every`` / ``resume``, ``save_folder``, ``profile_dir``,
    ``gather_dtype='bfloat16'``, and the methods ``partial_fit``,
    ``predict_factors``, ``add_user``, ``topN_batch``, ``save`` /
    ``load``.  ``gather_dtype`` ``'auto'`` and ``'float32'`` both mean the
    state dtype.
    """

    def __init__(self, k=30, a=0.3, a_prime=0.3, b_prime=1.0,
                 c=0.3, c_prime=0.3, d_prime=1.0, ncores=-1,
                 stop_crit='maxiter', check_every=10, stop_thr=1e-3,
                 users_per_batch=None, items_per_batch=None,
                 step_size=lambda x: 1 / np.sqrt(x + 2),
                 maxiter=100, use_float=True, reindex=True, verbose=True,
                 random_seed=None, allow_inconsistent_math=False, full_llk=False,
                 alloc_full_phi=False, keep_data=True, save_folder=None,
                 produce_dicts=True, keep_all_objs=True, sum_exp_trick=False,
                 *, mesh=None, block_size=None, engine="ell", shard_tables=False,
                 checkpoint_folder=None, checkpoint_every=None, halt_on_nan=True,
                 profile_dir=None, gather_dtype="auto", device="cuda"):

        # input checks, as hpfrec_tpu.HPF (reference hpfrec/__init__.py:214-314)
        assert isinstance(k, int)
        a = _as_float(a, "a")
        a_prime = _as_float(a_prime, "a_prime")
        b_prime = _as_float(b_prime, "b_prime")
        c = _as_float(c, "c")
        c_prime = _as_float(c_prime, "c_prime")
        d_prime = _as_float(d_prime, "d_prime")
        assert a > 0 and a_prime > 0 and b_prime > 0
        assert c > 0 and c_prime > 0 and d_prime > 0
        assert k > 0

        if ncores is None:
            ncores = 1
        if ncores < 1:
            import multiprocessing

            ncores = multiprocessing.cpu_count()
        assert ncores > 0
        assert isinstance(ncores, int)

        if ncores > 1:
            from .. import _native

            if not _native.get():
                warnings.warn(
                    "Attempting to use more than 1 thread, but the native "
                    "host-side data kernels were built without "
                    "multi-threading support - host preprocessing "
                    "(reindex/CSR/ELL packing) will run single-threaded; "
                    "device compute is unaffected.")

        if random_seed is not None:
            assert isinstance(random_seed, int)

        assert stop_crit in ['maxiter', 'train-llk', 'val-llk', 'diff-norm']

        if maxiter is not None:
            assert maxiter > 0
            assert isinstance(maxiter, int)
        else:
            if stop_crit == 'maxiter':
                raise ValueError(
                    "If 'stop_crit' is set to 'maxiter', must provide a maximum number of iterations.")
            maxiter = 10 ** 10

        if check_every is not None:
            assert isinstance(check_every, int)
            assert check_every > 0
            assert check_every <= maxiter
        else:
            if stop_crit != 'maxiter':
                raise ValueError(
                    "If 'stop_crit' is not 'maxiter', must input after how many iterations to calculate it.")
            check_every = 0

        if isinstance(stop_thr, int):
            stop_thr = float(stop_thr)
        if stop_thr is not None:
            assert stop_thr > 0
            assert isinstance(stop_thr, float)

        if save_folder is not None:
            save_folder = os.path.expanduser(save_folder)
            assert os.path.exists(save_folder)

        verbose = bool(verbose)
        if (stop_crit == 'maxiter') and (not verbose):
            check_every = 0

        if not isinstance(step_size, types.FunctionType):
            raise ValueError("'step_size' must be a function.")
        if len(inspect.getfullargspec(step_size).args) < 1:
            raise ValueError("'step_size' must be able to take the iteration number as input.")
        assert 0 <= step_size(0) <= 1
        assert 0 <= step_size(1) <= 1

        if users_per_batch is not None:
            if isinstance(users_per_batch, float):
                users_per_batch = int(users_per_batch)
            assert isinstance(users_per_batch, int)
            assert users_per_batch > 0
        else:
            users_per_batch = 0
        if items_per_batch is not None:
            if isinstance(items_per_batch, float):
                items_per_batch = int(items_per_batch)
            assert isinstance(items_per_batch, int)
            assert items_per_batch > 0
        else:
            items_per_batch = 0

        assert engine in ("ell", "coo")
        if engine == "coo" and shard_tables:
            raise ValueError(
                "shard_tables=True requires engine='ell'; the blocked-COO "
                "engine has no table-sharded (model-parallel) variant.")
        if checkpoint_every is not None:
            assert isinstance(checkpoint_every, int) and checkpoint_every > 0
        assert gather_dtype in ("auto", "float32", "bfloat16")

        # options of hpfrec_tpu.HPF that this package does not run yet
        if engine == "coo":
            raise _not_ported("engine='coo' (the blocked-COO engine, K7)", "9")
        if shard_tables or mesh is not None:
            raise _not_ported("Multi-device execution (mesh/shard_tables)", "10-11")
        if checkpoint_folder is not None or checkpoint_every is not None:
            raise _not_ported("Checkpointing (checkpoint_folder/checkpoint_every)", "5")
        if save_folder is not None:
            raise _not_ported("CSV export (save_folder)", "5")
        if profile_dir is not None:
            raise _not_ported("Fit tracing (profile_dir)", "5")
        if gather_dtype == "bfloat16":
            raise _not_ported("gather_dtype='bfloat16' (bf16 gather tables)", "3")

        self.k = k
        self.a = a
        self.a_prime = a_prime
        self.b_prime = b_prime
        self.c = c
        self.c_prime = c_prime
        self.d_prime = d_prime

        self.ncores = ncores
        self.allow_inconsistent_math = bool(allow_inconsistent_math)
        self.use_float = bool(use_float)
        self.random_seed = random_seed
        self.stop_crit = stop_crit
        self.reindex = bool(reindex)
        self.keep_data = bool(keep_data)
        self.maxiter = maxiter
        self.check_every = check_every
        self.stop_thr = stop_thr
        self.save_folder = save_folder
        self.verbose = verbose
        self.produce_dicts = bool(produce_dicts)
        self.full_llk = bool(full_llk)
        self.alloc_full_phi = bool(alloc_full_phi)
        self.keep_all_objs = bool(keep_all_objs)
        self.sum_exp_trick = bool(sum_exp_trick)
        self.step_size = step_size
        self.users_per_batch = users_per_batch
        self.items_per_batch = items_per_batch

        self.mesh = mesh
        self.block_size = block_size
        self.engine = engine
        self.shard_tables = bool(shard_tables)
        self.checkpoint_folder = checkpoint_folder
        self.checkpoint_every = checkpoint_every
        self.halt_on_nan = bool(halt_on_nan)
        self.profile_dir = profile_dir
        self.gather_dtype = gather_dtype
        self.device = device
        self.fit_stats_ = None

        if not self.reindex:
            self.produce_dicts = False

        self.Theta = None
        self.Beta = None
        self.user_mapping_ = None
        self.item_mapping_ = None
        self.user_dict_ = None
        self.item_dict_ = None
        self.is_fitted = False
        self.niter = None
        self.train_llk = None

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @property
    def _dtype(self):
        return np.float32 if self.use_float else np.float64

    def _hp(self) -> Hyperparams:
        return Hyperparams(a=self.a, a_prime=self.a_prime, b_prime=self.b_prime,
                           c=self.c, c_prime=self.c_prime, d_prime=self.d_prime,
                           k=self.k)

    def _torch_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "HPF(device='cuda') but CUDA is not available; pass "
                    "device='cpu' to run the plain PyTorch path")
            from .. import _cuda

            if self.k > _cuda.MAX_K:
                raise ValueError("k=%d is above the CUDA kernels' limit of %d"
                                 % (self.k, _cuda.MAX_K))
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
        return dev

    def _state_to_host(self, state: VariationalState):
        """Pull the fitted variational parameters back to host numpy (the
        reference's attribute names)."""
        G_shp, G_rte, L_shp, L_rte, k_rte, t_rte = (
            a.cpu().numpy() for a in state)
        self.Theta = G_shp / G_rte
        self.Beta = L_shp / L_rte
        if self.keep_all_objs:
            self.Gamma_shp = G_shp
            self.Gamma_rte = G_rte
            self.Lambda_shp = L_shp
            self.Lambda_rte = L_rte
            self.k_rte = k_rte
            self.t_rte = t_rte

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, counts_df, val_set=None, resume=False):
        """Fit the model to sparse count triplets (DataFrame / ndarray /
        scipy ``coo_array``), as ``hpfrec_tpu.HPF.fit`` does: full-batch
        CAVI, or mini-batch SVI when ``users_per_batch`` /
        ``items_per_batch`` are set; ``val_set`` (same formats) feeds the
        val-llk criterion."""
        if self.stop_crit == 'val-llk' and val_set is None:
            raise ValueError("If 'stop_crit' is set to 'val-llk', must provide a validation set.")
        if resume:
            raise _not_ported("Resuming from a checkpoint (resume=True)", "5")
        dev = self._torch_device()

        from .. import _native
        from ..utils.profiling import FitStats

        if _native.available():
            _native.set_num_threads(self.ncores)
        if self.verbose:
            self._print_st_msg()

        stats = FitStats(device=dev).start()
        self.fit_stats_ = stats

        with stats.phase("reindex"):
            pdata = data_utils.process_data(
                counts_df, self.stop_crit, self.reindex, self._dtype,
                sort_by_user=True)
        if pdata.user_mapping is None:
            self.reindex = False
            self.produce_dicts = False
        self.nusers = pdata.nusers
        self.nitems = pdata.nitems
        self.user_mapping_ = pdata.user_mapping
        self.item_mapping_ = pdata.item_mapping
        if self.verbose:
            self._print_data_info()

        val_arrays = None
        if (val_set is not None) and (self.stop_crit not in ("diff-norm", "train-llk")):
            with stats.phase("valset"):
                val_arrays = data_utils.process_valset(
                    val_set, self.stop_crit, self.reindex, self.user_mapping_,
                    self.item_mapping_, self.nusers, self.nitems, self._dtype,
                    is_valset=True)
            if val_arrays is None and self.stop_crit == 'val-llk':
                self.stop_crit = 'train-llk'

        svi_mode = (self.users_per_batch != 0) or (self.items_per_batch != 0)
        if self.block_size is not None and val_arrays is None:
            warnings.warn(
                "block_size has no effect on this fit: it sizes blocked-COO "
                "device buffers, which the ELL engine only allocates for a "
                "validation set (none in use here).")
        if svi_mode and self.users_per_batch != 0 and self.nusers < self.users_per_batch:
            warnings.warn("Batch size passed is larger than number of users. Will set it to nusers/10.")
            self.users_per_batch = int(np.ceil(self.nusers / 10))

        hp = self._hp()
        if self.verbose:
            print("Initializing parameters...")
        state = initialize_state(self.nusers, self.nitems, hp, self.random_seed,
                                 self._dtype)
        nnz = int(pdata.y.shape[0])
        stats.nnz = nnz
        self._nnz = nnz
        self._metric_ell = None
        self._val = None
        if val_arrays is not None:
            with stats.phase("valset"):
                self._val = self._device_valset(val_arrays, dev)

        if self.verbose:
            print("Initializing optimization procedure...")
        st_time = time.time()
        if svi_mode:
            state, colsums = self._run_svi(state, pdata, hp, dev, stats)
        else:
            state, colsums = self._run_full_batch(state, pdata, hp, dev, stats)
        end_tm = (time.time() - st_time) / 60.0
        with stats.phase("metric_checks"):
            self._final_eval(state, colsums)
        self._metric_ell = self._val = None  # per-fit device buffers
        stats.stop(self.niter + 1)
        if self.verbose:
            self._print_final_msg(self.niter + 1, self._last_llk, self._last_rmse, end_tm)

        self._state_to_host(state)
        if self.keep_data and (not svi_mode or not hasattr(self, "seen")):
            self._store_metadata(pdata)
        if self.produce_dicts and self.reindex:
            self.user_dict_ = {self.user_mapping_[i]: i for i in range(self.user_mapping_.shape[0])}
            self.item_dict_ = {self.item_mapping_[i]: i for i in range(self.item_mapping_.shape[0])}
        self.is_fitted = True
        return self

    def _device_valset(self, val_arrays, dev):
        """The validation triplets as a blocked COO stream on the device,
        with the unblocked ids kept on the host for the final eval."""
        from ..ops.cavi import device_blocked_coo

        vy, vu, vi = val_arrays
        data, nnz = device_blocked_coo(vy, vu, vi, dev, self.block_size)
        return types.SimpleNamespace(data=data, nnz=nnz, iu=vu, ii=vi)

    def _load_kernels(self, dev, stats):
        with stats.phase("kernel_build"):
            if dev.type == "cuda":
                from .. import _cuda

                _cuda.load()

    def _run_full_batch(self, state, pdata, hp, dev, stats):
        """Full-batch CAVI on the ELL engine.  Returns the final state and a
        function giving its mean colsums (for the train metric)."""
        from ..ops.ell import (_carry_init, build_layouts, run_cavi_block_ell,
                               to_device)

        with stats.phase("host_pack"):
            ell_u, ell_i = build_layouts(pdata, self._dtype)
        self._load_kernels(dev, stats)
        with stats.phase("transfer"):
            lay_u = to_device(ell_u, dev)
            lay_i = to_device(ell_i, dev)
            state = VariationalState(*[a.to(dev) for a in state])
        self._metric_ell = lay_u

        self._last_llk = 0.0
        self._last_rmse = 0.0
        self._last_check_it = None
        last_crit = None
        Theta_prev = state.G_shp / state.G_rte if self.stop_crit == 'diff-norm' else None

        iters_done = 0
        chunk = self.check_every if self.check_every > 0 else self.maxiter
        with stats.phase("iterations"):
            carry = _carry_init(state)
        while iters_done < self.maxiter:
            n = min(chunk, self.maxiter - iters_done)
            with stats.phase("iterations"):
                carry = run_cavi_block_ell(carry, lay_u, lay_i, n, hp)
            iters_done += n
            stop = False
            if self.check_every > 0 and n == self.check_every:
                with stats.phase("metric_checks"):
                    stop, last_crit, Theta_prev = self._evaluate_criterion(
                        carry.state, iters_done, last_crit, Theta_prev,
                        lambda c=carry: (c.theta_colsum, c.beta_colsum))
            if stop:
                break
        self.niter = iters_done - 1
        return carry.state, lambda: (carry.theta_colsum, carry.beta_colsum)

    def _run_svi(self, state, pdata, hp, dev, stats):
        """Mini-batch SVI epochs (reference ``cython_loops.pxi:261-377``):
        user epochs over CSR rows, item epochs over CSC rows, alternating
        when both batch sizes are set (item epoch first, the reference's
        parity rule at ``pxi:265-273``).  The numeration arrays are
        shuffled on the host by ``np.random.default_rng(random_seed)``, as
        in ``hpfrec_tpu``, so the epoch schedule is the same.  Returns the
        final state and a function giving its mean colsums."""
        from ..ops.cavi import side_derive
        from ..ops.ell import build_ell, to_device
        from ..ops.svi import epoch_side, svi_run_epoch

        dt = self._dtype
        use_users = self.users_per_batch > 0
        use_items = self.items_per_batch > 0
        with stats.phase("host_pack"):
            indptr_u, indices_u, data_u = data_utils.build_csr(
                pdata.ix_u, pdata.ix_i, pdata.y, self.nusers, self.nitems)
        self._st_ix_user = indptr_u
        self._n_seen_by_user = (indptr_u[1:] - indptr_u[:-1]).astype(np.int64)
        self.seen = indices_u
        if use_items:
            if self.verbose:
                print("Creating item indices for stochastic optimization...")
            with stats.phase("host_pack"):
                indptr_i, indices_i, data_i = data_utils.build_csr(
                    pdata.ix_i, pdata.ix_u, pdata.y, self.nitems, self.nusers)

        rng = np.random.default_rng(
            seed=self.random_seed if (self.random_seed is not None and self.random_seed > 0) else None)
        users_numeration = np.arange(self.nusers, dtype=np.int64) if use_users else None
        items_numeration = np.arange(self.nitems, dtype=np.int64) if use_items else None

        # train-metric checks ride a user-side ELL layout (untiled), built
        # only when a check or the final eval reads train metrics
        need_metric = (self._val is None) and (
            (self.check_every > 0 and self.stop_crit != 'diff-norm')
            or self.stop_crit == 'train-llk'
            or (self.verbose and self.stop_crit in ('diff-norm', 'maxiter')))
        ell_m = None
        if need_metric:
            with stats.phase("host_pack"):
                ell_m = build_ell(indptr_u, indices_u, data_u, self.nusers, dtype=dt)
        self._load_kernels(dev, stats)
        with stats.phase("transfer"):
            if ell_m is not None:
                self._metric_ell = to_device(ell_m, dev)
            side_u = epoch_side(indptr_u, indices_u, data_u, dt, dev) if use_users else None
            side_i = epoch_side(indptr_i, indices_i, data_i, dt, dev) if use_items else None
            state = VariationalState(*[a.to(dev) for a in state])

        def colsums(st):
            return lambda: (side_derive(st.G_shp, st.G_rte)[1],
                            side_derive(st.L_shp, st.L_rte)[1])

        self._last_llk = 0.0
        self._last_rmse = 0.0
        self._last_check_it = None
        last_crit = None
        Theta_prev = state.G_shp / state.G_rte if self.stop_crit == 'diff-norm' else None
        i = 0
        for i in range(self.maxiter):
            step = float(self.step_size(i))
            if use_users and use_items:
                user_epoch = ((i + 1) % 2) == 0
            else:
                user_epoch = use_users
            if user_epoch:
                with stats.phase("user_epochs"):
                    rng.shuffle(users_numeration)
                    state = svi_run_epoch(state, side_u, users_numeration,
                                          self.users_per_batch, step, hp, True)
            else:
                with stats.phase("item_epochs"):
                    rng.shuffle(items_numeration)
                    state = svi_run_epoch(state, side_i, items_numeration,
                                          self.items_per_batch, step, hp, False)
            if self.check_every > 0 and ((i + 1) % self.check_every) == 0:
                with stats.phase("metric_checks"):
                    stop, last_crit, Theta_prev = self._evaluate_criterion(
                        state, i + 1, last_crit, Theta_prev, colsums(state))
                if stop:
                    break
        self.niter = i
        # serve-time metadata keeps the truncated indptr like the reference
        # (hpfrec/__init__.py:424)
        self._st_ix_user = self._st_ix_user[:-1]
        return state, colsums(state)

    def _criterion_metric(self, state, colsums, use_val=True):
        """(llk, rmse, name) of one check: over the validation set when
        there is one (and ``use_val``), else the train metric on the
        user-side ELL layout with the colsums that ``colsums()`` gives."""
        from ..ops.metrics import ell_train_llk_rmse, val_llk_rmse

        Theta = state.G_shp / state.G_rte
        Beta = state.L_shp / state.L_rte
        if use_val and self._val is not None:
            llk, rmse = val_llk_rmse(Theta, Beta, self._val.data, self._val.nnz,
                                     self.full_llk)
            return llk, rmse, "val"
        theta_colsum, beta_colsum = colsums()
        llk, rmse = ell_train_llk_rmse(Theta, Beta, self._metric_ell, self._nnz,
                                       theta_colsum, beta_colsum, self.full_llk)
        return llk, rmse, "train"

    def _evaluate_criterion(self, state, it, last_crit, Theta_prev, colsums):
        """One convergence check (reference ``assess_convergence``,
        ``cython_loops.pxi:51-92``).  Returns (stop, last_crit, Theta_prev)."""
        from ..ops.metrics import theta_diff_norm

        if self.stop_crit == 'diff-norm':
            Theta = state.G_shp / state.G_rte
            norm = theta_diff_norm(Theta, Theta_prev)
            self._nan_sentinel(norm, it)
            if self.verbose:
                print("Iteration %d | Norm(Theta_{%d} - Theta_{%d}): %.5f"
                      % (it, it, it - self.check_every, norm))
            if norm < self.stop_thr:
                return True, norm, Theta_prev
            return False, norm, Theta
        llk, rmse, dname = self._criterion_metric(state, colsums)
        self._nan_sentinel(llk, it)
        self._last_llk, self._last_rmse = llk, rmse
        self._last_check_it = it
        if self.verbose:
            print("Iteration %d | %s llk: %d | %s rmse: %.4f"
                  % (it, dname, int(llk), dname, rmse))
        if self.stop_crit != 'maxiter':
            if it == self.check_every:
                return False, llk, Theta_prev
            if last_crit is not None and (1.0 - llk / last_crit) <= self.stop_thr:
                return True, last_crit, Theta_prev
            return False, llk, Theta_prev
        return False, last_crit, Theta_prev

    def _nan_sentinel(self, value, it):
        """Halt with a clear error on numerical blow-up."""
        if self.halt_on_nan and not np.isfinite(value):
            raise FloatingPointError(
                "Numerical blow-up at iteration %d (non-finite convergence "
                "metric). Try a different random seed or use_float=False."
                % it)

    def _final_eval(self, state, colsums):
        """Reference ``eval_after_term`` (``cython_loops.pxi:94-113``): the
        train-llk and val-llk criteria report their last check (recomputed
        when that check was not on the final iteration); diff-norm and
        maxiter compute a final llk+rmse only when verbose -- on a
        validation set with the ``rowsum_dot_rows`` correction, as the
        reference does (``pxi:105``)."""
        from ..ops.metrics import llk_rmse_sums, rowsum_dot_rows

        self.train_llk = None
        if self.stop_crit in ('train-llk', 'val-llk'):
            if self._last_check_it != self.niter + 1:
                llk, rmse, _ = self._criterion_metric(
                    state, colsums, use_val=self.stop_crit == 'val-llk')
                self._last_llk, self._last_rmse = llk, rmse
            self.train_llk = self._last_llk
            return
        if not self.verbose:
            return
        if self._val is not None:
            Theta = state.G_shp / state.G_rte
            Beta = state.L_shp / state.L_rte
            parts = llk_rmse_sums(Theta, Beta, self._val.data, self.full_llk).cpu().numpy()
            dev = Theta.device
            corr = rowsum_dot_rows(Theta, Beta, torch.from_numpy(self._val.iu).to(dev),
                                   torch.from_numpy(self._val.ii).to(dev))
            llk = float(parts[:, 0].sum()) - corr
            rmse = float(np.sqrt(parts[:, 1].sum() / self._val.nnz))
        else:
            llk, rmse, _ = self._criterion_metric(state, colsums)
        self._last_llk, self._last_rmse = llk, rmse
        self.train_llk = llk

    def _store_metadata(self, pdata):
        """Seen-items CSR for ``topN(exclude_seen=True)`` (reference
        ``_store_metadata``, ``hpfrec/__init__.py:587-606``)."""
        indptr, indices, _ = data_utils.build_csr(
            pdata.ix_u, pdata.ix_i, pdata.y, self.nusers, self.nitems)
        self._n_seen_by_user = (indptr[1:] - indptr[:-1]).astype(np.int64)
        self._st_ix_user = indptr[:-1]
        self.seen = indices

    # ------------------------------------------------------------------
    # serving (host numpy on the fitted factors)
    # ------------------------------------------------------------------
    def _map_ids(self, values, mapping, id_dict):
        """Vector id->row mapping with -1 for unknown."""
        if id_dict is not None and len(values) == 1:
            try:
                return np.array([id_dict[values[0]]])
            except (KeyError, TypeError):
                return np.array([-1])
        return data_utils.map_to_training_ids(np.asarray(values), mapping)

    def predict(self, user, item):
        """Predict counts for user/item pairs (reference ``HPF.predict``):
        scalar in -> scalar out, arrays in -> array out, NaN for unknown
        ids."""
        assert self.is_fitted
        user_arr = np.asarray(user).reshape(-1) if not np.isscalar(user) else np.array([user])
        item_arr = np.asarray(item).reshape(-1) if not np.isscalar(item) else np.array([item])

        if self.reindex:
            user_arr = self._map_ids(user_arr, self.user_mapping_, self.user_dict_)
            item_arr = self._map_ids(item_arr, self.item_mapping_, self.item_dict_)
        else:
            user_arr = user_arr.astype(np.int64)
            item_arr = item_arr.astype(np.int64)

        assert user_arr.shape[0] == item_arr.shape[0]

        if user_arr.shape[0] == 1:
            if (user_arr[0] == -1) or (item_arr[0] == -1):
                return np.nan
            return float(self.Theta[user_arr[0]].dot(self.Beta[item_arr[0]]))

        nan_entries = (user_arr == -1) | (item_arr == -1)
        if nan_entries.sum() == 0:
            return self._predict_arr(user_arr, item_arr)
        out = np.empty(user_arr.shape[0], dtype=self.Theta.dtype)
        out[~nan_entries] = self._predict_arr(user_arr[~nan_entries], item_arr[~nan_entries])
        out[nan_entries] = np.nan
        return out

    def _predict_arr(self, iu, ii):
        return np.einsum('ij,ij->i', self.Theta[iu], self.Beta[ii])

    def topN(self, user, n=10, exclude_seen=True, items_pool=None):
        """Top-N recommendations (reference ``HPF.topN``,
        ``hpfrec/__init__.py:1296-1396``), same exclusion and
        oversample-then-setdiff semantics."""
        if isinstance(n, float):
            n = int(n)
        assert isinstance(n, int)
        if self.reindex:
            if self.produce_dicts:
                try:
                    user = self.user_dict_[user]
                except (KeyError, TypeError):
                    raise ValueError("Can only predict for users who were in the training set.")
            else:
                user = data_utils.map_to_training_ids(np.array([user]), self.user_mapping_)[0]
                if user == -1:
                    raise ValueError("Can only predict for users who were in the training set.")
        if exclude_seen and not self.keep_data:
            raise Exception("Can only exclude seen items when passing 'keep_data=True' to .fit")

        if items_pool is None:
            allpreds = -(self.Theta[user].dot(self.Beta.T))
            if exclude_seen:
                n_ext = int(np.min([n + self._n_seen_by_user[user], self.Beta.shape[0]]))
                rec = np.argpartition(allpreds, n_ext - 1)[:n_ext]
                seen = self.seen[self._st_ix_user[user]:
                                 self._st_ix_user[user] + self._n_seen_by_user[user]]
                rec = np.setdiff1d(rec, seen)
                rec = rec[np.argsort(allpreds[rec])[:n]]
            else:
                n = int(np.min([n, self.Beta.shape[0]]))
                rec = np.argpartition(allpreds, n - 1)[:n]
                rec = rec[np.argsort(allpreds[rec])]
            return self.item_mapping_[rec] if self.reindex else rec

        items_pool = np.asarray(items_pool).reshape(-1)
        if self.reindex:
            items_pool_reind = data_utils.map_to_training_ids(items_pool, self.item_mapping_)
            nan_ix = items_pool_reind == -1
            if nan_ix.sum() > 0:
                items_pool_reind = items_pool_reind[~nan_ix]
                warnings.warn("There were %d entries from 'item_pool' that were not in the "
                              "training data and will be exluded." % int(nan_ix.sum()))
            if items_pool_reind.shape[0] == 0:
                raise ValueError("No items to recommend.")
            if items_pool_reind.shape[0] == 1:
                raise ValueError("Only 1 item to recommend.")
            allpreds = -self.Theta[user].dot(self.Beta[items_pool_reind].T)
        else:
            allpreds = -self.Theta[user].dot(self.Beta[items_pool].T)
        n = int(np.min([n, items_pool.shape[0]]))
        if exclude_seen:
            n_ext = int(np.min([n + self._n_seen_by_user[user], items_pool.shape[0]]))
            rec = np.argpartition(allpreds, n_ext - 1)[:n_ext]
            seen = self.seen[self._st_ix_user[user]:
                             self._st_ix_user[user] + self._n_seen_by_user[user]]
            if self.reindex:
                rec = np.setdiff1d(items_pool_reind[rec], seen)
                allpreds = -self.Theta[user].dot(self.Beta[rec].T)
                return self.item_mapping_[rec[np.argsort(allpreds)[:n]]]
            rec = np.setdiff1d(items_pool[rec], seen)
            allpreds = -self.Theta[user].dot(self.Beta[rec].T)
            return rec[np.argsort(allpreds)[:n]]
        rec = np.argpartition(allpreds, n - 1)[:n]
        return items_pool[rec[np.argsort(allpreds[rec])]]

    def eval_llk(self, input_df, full_llk=False):
        """Poisson log-likelihood (plus constant) of the given triplets
        (reference ``HPF.eval_llk``, ``hpfrec/__init__.py:1399-1446``), on
        the model's device through K5."""
        from ..ops.cavi import device_blocked_coo
        from ..ops.metrics import llk_rmse_sums

        assert self.is_fitted
        y, iu, ii = data_utils.process_valset(
            input_df, self.stop_crit, self.reindex, self.user_mapping_,
            self.item_mapping_, self.nusers, self.nitems, self._dtype,
            is_valset=False)
        dev = self._torch_device()
        data, _ = device_blocked_coo(y, iu, ii, dev)
        parts = llk_rmse_sums(torch.from_numpy(self.Theta).to(dev),
                              torch.from_numpy(self.Beta).to(dev), data,
                              bool(full_llk)).cpu().numpy()
        llk = float(parts[:, 0].sum()) - float(parts[:, 2].sum())
        return {'llk': llk, 'nobs': int(y.shape[0])}

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    def partial_fit(self, *args, **kwargs):
        raise _not_ported("partial_fit", "8")

    def predict_factors(self, *args, **kwargs):
        raise _not_ported("predict_factors", "8")

    def add_user(self, *args, **kwargs):
        raise _not_ported("add_user", "8")

    def topN_batch(self, *args, **kwargs):
        raise _not_ported("topN_batch (kernel K6)", "6")

    def save(self, path):
        raise _not_ported("save", "5")

    @classmethod
    def load(cls, path, step_size=None):
        raise _not_ported("load", "5")

    # ------------------------------------------------------------------
    # printing (reference formats: hpfrec/__init__.py:1448-1458,
    # cython_loops.pxi:828-847)
    # ------------------------------------------------------------------
    def _print_st_msg(self):
        print("**********************************")
        print("Hierarchical Poisson Factorization")
        print("**********************************")
        print("")

    def _print_data_info(self):
        print("Number of users: %d" % self.nusers)
        print("Number of items: %d" % self.nitems)
        print("Latent factors to use: %d" % self.k)
        print("")

    def _print_final_msg(self, it, llk, rmse, end_tm):
        print("\n\nOptimization finished")
        print("Final log-likelihood: %d" % int(llk))
        print("Final RMSE: %.4f" % rmse)
        print("Minutes taken (optimization part): %.1f" % end_tm)
        if self.fit_stats_ is not None and self.fit_stats_.nnz_per_second > 0:
            print("Nonzero updates per second (end-to-end): %.3g"
                  % self.fit_stats_.nnz_per_second)
            report = self.fit_stats_.phase_report()
            if report:
                print("Wall-time breakdown:")
                print(report)
        print("")
