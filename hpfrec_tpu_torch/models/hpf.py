"""The ``HPF`` model class on PyTorch: full-batch CAVI, mini-batch SVI,
batch serving, online updates and persistence, on one device or in data
parallel over ``torch.distributed``.

Port of ``hpfrec_tpu/models/hpf.py`` (itself API-compatible with the
reference ``hpfrec/__init__.py:11-1459``): the constructor with all of the
reference's arguments and their validation; ``fit`` in full-batch CAVI on
the bucketed-ELL engine (with bfloat16 gather tables on request) or the
blocked-COO engine, or in mini-batch SVI (``users_per_batch`` /
``items_per_batch``), with all four stopping criteria and a validation
set, checkpoints and resume, the end-of-fit CSV export (``save_folder``)
and a trace of the fit (``profile_dir``); ``eval_llk``; ``save`` /
``load`` (files that ``hpfrec_tpu`` reads and writes too); ``predict`` /
``topN`` on the fitted host factors, with large ``predict`` batches
(65,536 pairs or more) on the device;
``topN_batch`` on a cached device ``Beta``; and the online updates
``partial_fit`` (with ``new_users`` / ``new_items`` growth),
``predict_factors`` and ``add_user``, which keep the device state cached
between calls.  The device work runs the hand-written CUDA kernels of
``hpfrec_tpu_torch/csrc`` on a CUDA device, and their plain PyTorch
versions on the CPU.

One keyword-only argument is new: ``device`` (default ``"cuda"``).  With
``device="cuda"`` and no CUDA, ``fit`` raises; nothing falls back to the
CPU.

``mesh`` (a ``parallel.Mesh``, one process per device) fits in data
parallel: every rank runs the same script on the same data, takes its
share of the nonzeros through the kernels, and meets the other ranks in
a collective (``parallel/engine.py``, K12); every rank ends with the same
fitted attributes.  ``mesh=None`` is one device, where JAX's means all
local devices.  With ``shard_tables=True`` a full-batch ELL fit over more
than one rank runs the table-sharded engine (``parallel/table_sharded.py``,
K13): each rank holds a block of rows of both factor tables, and the
opposite exp table travels around a ring.  Fixed (seed, dtype, device,
mesh size) gives bit-identical runs: no kernel uses atomics.
"""

from __future__ import annotations

import inspect
import os
import time
import types
import warnings
import weakref

import numpy as np
import torch

from ..utils import data as data_utils
from .state import (Hyperparams, VariationalState, initialize_extra_rows,
                    initialize_state)


def _as_float(x, name):
    if isinstance(x, int):
        x = float(x)
    assert isinstance(x, float), f"'{name}' must be a number"
    return x


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor in memory that numpy owns (so that its
    write flag can be turned off and on again)."""
    out = np.empty(tuple(t.shape), dtype=np.float32 if t.dtype == torch.float32
                   else np.float64)
    torch.from_numpy(out).copy_(t)
    return out


def _host_to_device(a, device) -> torch.Tensor:
    """A device copy of a host array; never shares memory with it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, copy=True)


class HPF:
    """Hierarchical Poisson Factorization, fit by full-batch CAVI or
    mini-batch SVI on one PyTorch device.

    The constructor signature and defaults match ``hpfrec_tpu.HPF`` and the
    reference ``HPF`` (``hpfrec/__init__.py:205-358``); see
    ``hpfrec_tpu.models.hpf.HPF`` for every parameter.  Differences:

    device : str or torch.device, keyword-only, default ``"cuda"``
        Where the iterations run.  ``"cuda"`` launches the port's CUDA
        kernels and raises in ``fit`` when CUDA is absent; ``"cpu"`` runs
        the kernels' plain PyTorch versions.  With a ``mesh`` the model
        runs on ``mesh.device`` instead.
    mesh : hpfrec_tpu_torch.parallel.Mesh or None
        This process's rank of a data-parallel group
        (``parallel.distributed.initialize`` or ``parallel.make_mesh``).
        None: one device (JAX's None is all local devices).  Every rank
        calls ``fit`` / ``partial_fit`` with the same data; checkpoints,
        ``save_folder`` and ``profile_dir`` are written by rank 0.

    ``shard_tables=True`` on a full-batch ELL fit over more than one rank
    shards both factor tables over the ranks (``parallel/table_sharded.py``);
    every rank still ends with the whole fitted state.  ``gather_dtype``
    ``'auto'`` and ``'float32'`` both mean the
    state dtype (JAX's ``'auto'`` picks bfloat16 above a TPU threshold);
    ``'bfloat16'`` stores the ELL engine's exp tables in bfloat16.
    ``save_folder`` writes ``users.csv`` / ``items.csv`` without pandas;
    ``profile_dir`` receives a ``torch.profiler`` Chrome trace.

    ``partial_fit``, ``predict_factors``, ``add_user`` and
    ``utils.evaluation`` take an ``(n, 3)`` / ``(n, 2)`` ndarray (and a
    DataFrame when pandas is installed).  The fitted state arrays that the
    model allocates itself are cached on the device and made read-only;
    reassign an attribute to change it (a caller's array is never made
    read-only, and is uploaded on every call instead).
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
        if engine == "coo" and gather_dtype != "auto":
            warnings.warn(
                "gather_dtype=%r has no effect with engine='coo' (the "
                "blocked-COO engine computes in the state dtype); use "
                "engine='ell' for reduced-precision gather tables."
                % (gather_dtype,))
        if checkpoint_every is not None:
            assert isinstance(checkpoint_every, int) and checkpoint_every > 0
        assert gather_dtype in ("auto", "float32", "bfloat16")

        from ..parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "'mesh' must be a hpfrec_tpu_torch.parallel.Mesh (from "
                "parallel.distributed.initialize or parallel.make_mesh), not %s"
                % type(mesh).__name__)

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
        self._host_owned = {}  # attribute name -> the array the model allocated
        self._grown = {}  # attribute name -> weakref to its view of a growth buffer
        self._dev_state_cache = None
        self._beta_dev_cache = None
        self._beta_colsum_cache = None

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
        dev = self.mesh.device if self.mesh is not None else torch.device(self.device)
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

    # -- host attributes and their device copies --------------------------
    _STATE_ATTRS = ("Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
                    "k_rte", "t_rte")

    def _own(self, name, arr):
        """Set a host attribute to an array the model allocated itself: only
        such arrays are cached on the device and made read-only."""
        setattr(self, name, arr)
        self._host_owned[name] = arr

    def _is_owned(self, name) -> bool:
        a = getattr(self, name, None)
        return a is not None and self._host_owned.get(name) is a

    def _append_rows(self, name, rows, own=True):
        """Set attribute ``name`` to ``np.r_[old, rows]`` in amortized time.
        The model grows the array inside a buffer with spare rows after it
        (an eighth more at each reallocation), so adding one user to a
        table of a million rows writes one row where ``np.r_`` copies the
        whole table.  The attribute is a leading view of the buffer; its
        spare rows are reused only while the attribute is still that view
        (``own``: the view counts as an array the model allocated).  An
        earlier view of the same buffer, which a caller may hold, shares
        its rows with the new one: ``_unshare`` copies the attribute out
        before an in-place edit, so such a view keeps its values as it
        would after ``np.r_``."""
        old = getattr(self, name)
        rows = np.asarray(rows)
        n, m = old.shape[0], rows.shape[0]
        dt = np.result_type(old, rows)
        ref = self._grown.get(name)
        buf = old.base if ref is not None and ref() is old else None
        if buf is None or buf.shape[0] < n + m or dt != old.dtype:
            buf = np.empty((n + m + max(64, (n + m) // 8),) + old.shape[1:], dtype=dt)
            buf[:n] = old
        buf[n:n + m] = rows
        new = buf[:n + m]
        self._grown[name] = weakref.ref(new)
        if own:
            self._own(name, new)
        else:
            setattr(self, name, new)

    def _unshare(self, name):
        """Before an in-place row edit: replace an attribute that is a view
        of a growth buffer by a copy of its own (owned as before)."""
        ref = self._grown.pop(name, None)
        arr = getattr(self, name)
        if ref is None or ref() is not arr:
            return
        if self._is_owned(name):
            self._own(name, arr.copy())
        else:
            setattr(self, name, arr.copy())

    def _freeze_owned(self, names):
        """Make the model's own cached host arrays read-only: an in-place
        edit could evade the strided fingerprint and serve stale device
        state, so the mutation contract is reassignment."""
        for name in names:
            if self._is_owned(name):
                getattr(self, name).flags.writeable = False

    def _thaw_attr(self, name):
        """Re-enable writes on the model's own frozen array for the
        library's in-place edit paths (which drop the device caches)."""
        if self._is_owned(name):
            getattr(self, name).flags.writeable = True

    def _state_fingerprint(self):
        """Shape/dtype + strided-sample fingerprint of the six host state
        arrays, for the device-state cache.  None when any is missing
        (keep_all_objs=False).  Identity is checked separately through held
        references, never raw ``id()``."""
        parts = []
        for name in self._STATE_ATTRS:
            a = getattr(self, name, None)
            if a is None:
                return None
            arr = np.asarray(a)
            sample = arr.ravel()[:: max(1, arr.size // 256)][:256]
            parts.append((arr.shape, str(arr.dtype), sample.tobytes()))
        return tuple(parts)

    def _state_refs(self):
        return tuple(getattr(self, name, None) for name in self._STATE_ATTRS)

    def _state_to_host(self, state: VariationalState):
        """Pull the fitted variational parameters back to host numpy (the
        reference's attribute names); these attributes are the source of
        truth between calls.  With ``keep_all_objs`` the device state stays
        cached for the next online update, keyed on the held host arrays
        and their fingerprint."""
        G_shp, G_rte, L_shp, L_rte, k_rte, t_rte = (_to_host(a) for a in state)
        self._own("Theta", G_shp / G_rte)
        self._own("Beta", L_shp / L_rte)
        self._beta_dev_cache = self._beta_colsum_cache = None
        self._dev_state_cache = None
        if self.keep_all_objs:
            for name, arr in zip(self._STATE_ATTRS,
                                 (G_shp, G_rte, L_shp, L_rte, k_rte, t_rte)):
                self._own(name, arr)
            # a table-sharded fit's state comes back on the host: not cached
            if state.G_shp.device.type == self._torch_device().type:
                self._dev_state_cache = (self._state_fingerprint(), state, self._state_refs())
            self._freeze_owned(self._STATE_ATTRS)

    def _state_from_host(self) -> VariationalState:
        """The device state from the host attributes, from the cache when
        the six arrays are the same objects with the same fingerprint (the
        repeated upload of ~1.1 GB at the MillionSong shape otherwise).
        Library paths reassign the attributes or drop the cache explicitly
        (``add_user``'s in-place row edit); only arrays the model allocated
        itself are cached and frozen."""
        fp = self._state_fingerprint()
        cached = self._dev_state_cache
        if (cached is not None and fp is not None and cached[0] == fp
                and all(c is r for c, r in zip(cached[2], self._state_refs()))):
            return cached[1]
        dev = self._torch_device()
        state = VariationalState(*[_host_to_device(getattr(self, name), dev)
                                   for name in self._STATE_ATTRS])
        if fp is not None and all(self._is_owned(name) for name in self._STATE_ATTRS):
            self._dev_state_cache = (fp, state, self._state_refs())
            self._freeze_owned(self._STATE_ATTRS)
        else:
            self._dev_state_cache = None
        return state

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, counts_df, val_set=None, resume=False):
        """Fit the model to sparse count triplets (DataFrame / ndarray /
        scipy ``coo_array``), as ``hpfrec_tpu.HPF.fit`` does: full-batch
        CAVI, or mini-batch SVI when ``users_per_batch`` /
        ``items_per_batch`` are set; ``val_set`` (same formats) feeds the
        val-llk criterion.

        With ``checkpoint_folder`` / ``checkpoint_every`` set at
        construction, the six state arrays, the iteration counter (and in
        SVI the shuffle rng and the numeration arrays) are written during
        the fit; ``resume=True`` continues from the latest checkpoint,
        one written by this package or by ``hpfrec_tpu``."""
        if self.stop_crit == 'val-llk' and val_set is None:
            raise ValueError("If 'stop_crit' is set to 'val-llk', must provide a validation set.")
        svi_mode = (self.users_per_batch != 0) or (self.items_per_batch != 0)
        if self.shard_tables and svi_mode:
            warnings.warn(
                "shard_tables=True is ignored in mini-batch SVI mode "
                "(users_per_batch/items_per_batch): only the full-batch ELL "
                "engine has a table-sharded variant; SVI shards each batch's "
                "phi sums over the mesh instead.")
        dev = self._torch_device()

        from .. import _native
        from ..utils.profiling import FitStats, maybe_trace

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

        if self.save_folder is not None:
            self._on_rank0(self._save_mappings)

        val_arrays = None
        if (val_set is not None) and (self.stop_crit not in ("diff-norm", "train-llk")):
            with stats.phase("valset"):
                val_arrays = data_utils.process_valset(
                    val_set, self.stop_crit, self.reindex, self.user_mapping_,
                    self.item_mapping_, self.nusers, self.nitems, self._dtype,
                    is_valset=True)
            if val_arrays is None and self.stop_crit == 'val-llk':
                self.stop_crit = 'train-llk'

        if self.engine == "ell" and self.block_size is not None and val_arrays is None:
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
        self._fit_seed = self._agreed_seed(self.random_seed)
        self._resume_meta = None
        if resume:
            state = self._resume_state()
        else:
            state = initialize_state(self.nusers, self.nitems, hp, self._fit_seed,
                                     self._dtype)
        nnz = int(pdata.y.shape[0])
        stats.nnz = nnz
        self._nnz = nnz
        self._metric_ell = None
        self._metric_coo = None
        self._table_shard = None
        self._val = None
        if val_arrays is not None:
            with stats.phase("valset"):
                self._val = self._device_valset(val_arrays, dev)

        if self.verbose:
            print("Initializing optimization procedure...")
        st_time = time.time()
        with maybe_trace(self.profile_dir if self._shard[0] == 0 else None):
            if svi_mode:
                state, colsums = self._run_svi(state, pdata, hp, dev, stats)
            else:
                state, colsums = self._run_full_batch(state, pdata, hp, dev, stats)
        if self.profile_dir and self.mesh is not None:
            self._on_rank0(lambda: None)  # the trace is on disk when fit returns
        end_tm = (time.time() - st_time) / 60.0
        with stats.phase("metric_checks"):
            self._final_eval(state, colsums)
            state = self._real_state(state)
        # per-fit device buffers
        self._metric_ell = self._metric_coo = self._val = self._table_shard = None
        stats.stop(self.niter + 1)
        if self.verbose:
            self._print_final_msg(self.niter + 1, self._last_llk, self._last_rmse, end_tm)

        self._state_to_host(state)
        if self.save_folder is not None:
            self._on_rank0(lambda: self._save_parameters(state))
        if self.keep_data and (not svi_mode or not hasattr(self, "seen")):
            self._store_metadata(pdata)
        if self.produce_dicts and self.reindex:
            self.user_dict_ = {self.user_mapping_[i]: i for i in range(self.user_mapping_.shape[0])}
            self.item_dict_ = {self.item_mapping_[i]: i for i in range(self.item_mapping_.shape[0])}
        self.is_fitted = True
        return self

    def _save_mappings(self):
        from ..utils.io import series_csv

        if self.reindex:
            if self.verbose:
                print("\nSaving user and item mappings...\n")
            series_csv(os.path.join(self.save_folder, 'users.csv'), self.user_mapping_)
            series_csv(os.path.join(self.save_folder, 'items.csv'), self.item_mapping_)
        data_utils.hyperparams_txt(
            self.save_folder, self.a, self.a_prime, self.b_prime,
            self.c, self.c_prime, self.d_prime, self.k, self.random_seed)

    # -- data parallel ---------------------------------------------------
    @property
    def _n_ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.world_size

    @property
    def _table_sharded(self) -> bool:
        """Whether a full-batch fit takes the table-sharded engine (JAX
        ``hpf.py:925``): ``shard_tables=True``, the ELL engine, more than one
        rank."""
        return self.shard_tables and self.engine == "ell" and self._n_ranks > 1

    def _real_state(self, state):
        """The fit's whole state, real rows in their original order, from
        what the loop holds: the same state, or in a table-sharded fit the
        rank's padded rows, gathered from every rank onto the host one array
        at a time."""
        return state if self._table_shard is None else self._table_shard.real_state(state)

    def _real_factors(self, state):
        """(Theta, Beta) on the device, real rows in their original order:
        in a table-sharded fit gathered from every rank (a validation check
        then holds both whole tables on every device, as a one-device fit
        does)."""
        Theta = state.G_shp / state.G_rte
        Beta = state.L_shp / state.L_rte
        ts = self._table_shard
        if ts is None:
            return Theta, Beta
        Theta = ts.gather_rows(Theta, True)
        return Theta, ts.gather_rows(Beta, False)

    @property
    def _shard(self):
        """This rank's (rank, n_ranks), for the shard forms of the uploads."""
        return (0, 1) if self.mesh is None else (self.mesh.rank, self.mesh.world_size)

    def _exchanges(self):
        """Where a fit takes its phi sums and llk partials from: the
        one-device kernels, or with a mesh K12's sharded forms over it
        (``parallel/engine.py``), which the loops of ``ops/`` call in their
        place.  ``ell``, ``coo`` and ``svi`` take the arguments of
        ``ell_phi_sums``, ``coo_phi_sums`` and ``batch_phi_sums``;
        ``partials`` maps the rank's llk partials to every rank's."""
        if self.mesh is None:
            from ..ops.cavi import coo_phi_sums
            from ..ops.ell import ell_phi_sums
            from ..ops.svi import batch_phi_sums

            return types.SimpleNamespace(ell=ell_phi_sums, coo=coo_phi_sums,
                                         svi=batch_phi_sums, partials=lambda parts: parts)
        from functools import partial

        from ..parallel import engine as P

        return types.SimpleNamespace(
            ell=partial(P.sharded_ell_phi_sums, self.mesh),
            coo=partial(P.sharded_coo_phi_sums, self.mesh),
            svi=partial(P.sharded_svi_phi_sums, self.mesh),
            partials=partial(P.gather_partials, self.mesh))

    def _agreed_seed(self, seed):
        """``seed``, or with a mesh a seed every rank shares (rank 0's draw
        when ``seed`` is not a positive int)."""
        if self.mesh is None:
            return seed
        from ..parallel.engine import agreed_seed

        return agreed_seed(self.mesh, seed)

    def _on_rank0(self, write):
        """Run ``write`` (a file write) once: on rank 0 of the mesh, and then
        every rank waits for it; without a mesh, here."""
        if self.mesh is None:
            write()
            return
        from ..parallel.engine import barrier

        if self.mesh.rank == 0:
            write()
        barrier(self.mesh)

    def _device_valset(self, val_arrays, dev):
        """The validation triplets as a blocked COO stream on the device
        (with a mesh: the rank's share of the blocks), with the unblocked
        ids kept on the host for the final eval."""
        from ..ops.cavi import device_blocked_coo

        vy, vu, vi = val_arrays
        data, nnz = device_blocked_coo(vy, vu, vi, dev, self.block_size, self._shard)
        return types.SimpleNamespace(data=data, nnz=nnz, iu=vu, ii=vi)

    def _resume_state(self) -> VariationalState:
        """The state of the latest checkpoint, as host tensors of the fit's
        dtype; keeps its meta and rng for the loop (JAX ``hpf.py:705-720``)."""
        from ..models.state import state_from_numpy
        from ..utils import io as io_utils

        if not io_utils.has_checkpoint(self.checkpoint_folder):
            raise ValueError(
                "resume=True but no checkpoint found in 'checkpoint_folder'.")
        ck_state, meta, ck_rng = io_utils.load_checkpoint(self.checkpoint_folder)
        if ck_state.G_shp.shape != (self.nusers, self.k):
            raise ValueError(
                "Checkpoint shape %s does not match data (%d users, k=%d)."
                % (ck_state.G_shp.shape, self.nusers, self.k))
        self._resume_meta = (meta, ck_rng)
        if self.verbose:
            print("Resuming from checkpoint at iteration %d..." % meta["niter"])
        return state_from_numpy([a.astype(self._dtype, copy=False) for a in ck_state], "cpu")

    def _maybe_checkpoint(self, state, iters_done, rng=None, last_crit=None,
                          extra_arrays=None):
        """Write a checkpoint when ``iters_done`` is a multiple of
        ``checkpoint_every`` (JAX ``hpf.py:881-898``)."""
        if self.checkpoint_folder is None or self.checkpoint_every is None:
            return
        if iters_done % self.checkpoint_every == 0:
            from ..utils import io as io_utils

            state = self._real_state(state)  # JAX hpf.py:888-892: real rows only
            extra = {}
            if last_crit is not None:
                extra["last_crit"] = float(last_crit)
            with self.fit_stats_.phase("checkpoints"):
                self._on_rank0(lambda: io_utils.save_checkpoint(
                    self.checkpoint_folder, state, iters_done, rng=rng, extra=extra,
                    extra_arrays=extra_arrays))

    def _load_kernels(self, dev, stats):
        with stats.phase("kernel_build"):
            if dev.type == "cuda":
                from .. import _cuda

                _cuda.load()

    def _run_full_batch(self, state, pdata, hp, dev, stats):
        """Full-batch CAVI on the ELL engine (K1-K3; bfloat16 exp tables
        with ``gather_dtype='bfloat16'``) or the blocked-COO engine (K7c,
        K3); with a mesh, on the rank's share of the layouts or of the
        stream (K12a, K12c), or with ``shard_tables=True`` on the rank's
        rows of both tables (K13, ``parallel/table_sharded.py``).  Returns
        the final state (table-sharded: the rank's padded rows, which
        ``_real_state`` gathers) and a function giving its mean colsums (for
        the train metric)."""
        from ..ops.cavi import _carry_init, coo_stream, run_cavi_block_coo
        from ..ops.ell import (build_layouts, gather_table_dtype, run_cavi_block_ell,
                               to_device)

        coo = ts = None
        gd = None
        if self.engine == "coo":
            with stats.phase("host_pack"):
                coo = coo_stream(pdata, dev, self.block_size, self._shard)
            self._metric_coo = coo.data
            self._load_kernels(dev, stats)
        elif self._table_sharded:
            from ..parallel.table_sharded import (CARD_WINDOW_BYTES, TableSharded,
                                                  prepare_table_sharded)

            gd = gather_table_dtype(self.gather_dtype)
            g_item = 2 if gd is not None else np.dtype(self._dtype).itemsize
            with stats.phase("host_pack"):
                csr_u = data_utils.build_csr(pdata.ix_u, pdata.ix_i, pdata.y, self.nusers,
                                             self.nitems)
                csr_i = data_utils.build_csr(pdata.ix_i, pdata.ix_u, pdata.y, self.nitems,
                                             self.nusers)
                plan = prepare_table_sharded(*csr_u, *csr_i, self.nusers, self.nitems, self.k,
                                             self._n_ranks, g_item, dtype=self._dtype,
                                             window_bytes=CARD_WINDOW_BYTES)
                del csr_u, csr_i
            self._load_kernels(dev, stats)
            with stats.phase("transfer"):
                ts = self._table_shard = TableSharded(self.mesh, plan, self.nusers,
                                                      self.nitems, dev)
                del plan
        else:
            gd = gather_table_dtype(self.gather_dtype)
            with stats.phase("host_pack"):
                ell_u, ell_i = build_layouts(pdata, self._dtype, self._n_ranks)
            self._load_kernels(dev, stats)
            with stats.phase("transfer"):
                lay_u = to_device(ell_u, dev, self._shard)
                lay_i = to_device(ell_i, dev, self._shard)
            self._metric_ell = lay_u
        with stats.phase("transfer"):
            state = (ts.shard_state(state) if ts is not None
                     else VariationalState(*[a.to(dev) for a in state]))

        self._last_llk = 0.0
        self._last_rmse = 0.0
        self._last_check_it = None
        last_crit = None
        Theta_prev = state.G_shp / state.G_rte if self.stop_crit == 'diff-norm' else None

        iters_done = 0
        if self._resume_meta is not None:
            meta, _ = self._resume_meta
            iters_done = int(meta["niter"])
            last_crit = meta.get("last_crit")
        chunk = self.check_every if self.check_every > 0 else self.maxiter
        ex = self._exchanges()
        with stats.phase("iterations"):
            carry = ts.carry_init(state, gd) if ts is not None else _carry_init(state, gd)
        while iters_done < self.maxiter:
            n = min(chunk, self.maxiter - iters_done)
            with stats.phase("iterations"):
                if coo is not None:
                    carry = run_cavi_block_coo(carry, coo, n, hp, ex.coo)
                elif ts is not None:
                    carry = ts.run(carry, n, hp, gd)
                else:
                    carry = run_cavi_block_ell(carry, lay_u, lay_i, n, hp, gd, ex.ell)
            iters_done += n
            stop = False
            if self.check_every > 0 and n == self.check_every:
                with stats.phase("metric_checks"):
                    stop, last_crit, Theta_prev = self._evaluate_criterion(
                        carry.state, iters_done, last_crit, Theta_prev,
                        lambda c=carry: (c.theta_colsum, c.beta_colsum))
            self._maybe_checkpoint(carry.state, iters_done, last_crit=last_crit)
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

        seed = self._fit_seed
        rng = np.random.default_rng(seed=seed if (seed is not None and seed > 0) else None)
        users_numeration = np.arange(self.nusers, dtype=np.int64) if use_users else None
        items_numeration = np.arange(self.nitems, dtype=np.int64) if use_items else None

        # train-metric checks ride the blocked-COO training stream under
        # engine='coo' (JAX hpf.py:1269); else a user-side ELL layout
        # (untiled), built only when a check or the final eval reads train
        # metrics
        need_metric = (self._val is None) and (
            (self.check_every > 0 and self.stop_crit != 'diff-norm')
            or self.stop_crit == 'train-llk'
            or (self.verbose and self.stop_crit in ('diff-norm', 'maxiter')))
        ell_m = None
        if self.engine == "coo":
            from ..ops.cavi import device_blocked_coo

            with stats.phase("host_pack"):
                self._metric_coo = device_blocked_coo(pdata.y, pdata.ix_u, pdata.ix_i, dev,
                                                      self.block_size, self._shard)[0]
        elif need_metric:
            with stats.phase("host_pack"):
                ell_m = build_ell(indptr_u, indices_u, data_u, self.nusers, dtype=dt,
                                  pad_shards=self._n_ranks)
        self._load_kernels(dev, stats)
        with stats.phase("transfer"):
            if ell_m is not None:
                self._metric_ell = to_device(ell_m, dev, self._shard)
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
        svi_sums = self._exchanges().svi
        i = 0
        start_epoch = 0
        if self._resume_meta is not None:
            meta, ck_rng = self._resume_meta
            start_epoch = int(meta["niter"])
            last_crit = meta.get("last_crit")
            if ck_rng is not None:
                rng = ck_rng
            # the shuffles permute the numeration arrays in place, so the
            # permutations are loop state and are restored with the rng
            xa = meta.get("extra_arrays", {})
            if "users_numeration" in xa:
                users_numeration = xa["users_numeration"].astype(np.int64)
            if "items_numeration" in xa:
                items_numeration = xa["items_numeration"].astype(np.int64)
        for i in range(start_epoch, self.maxiter):
            step = float(self.step_size(i))
            if use_users and use_items:
                user_epoch = ((i + 1) % 2) == 0
            else:
                user_epoch = use_users
            if user_epoch:
                with stats.phase("user_epochs"):
                    rng.shuffle(users_numeration)
                    state = svi_run_epoch(state, side_u, users_numeration,
                                          self.users_per_batch, step, hp, True,
                                          phi_sums=svi_sums, shard=self._shard)
            else:
                with stats.phase("item_epochs"):
                    rng.shuffle(items_numeration)
                    state = svi_run_epoch(state, side_i, items_numeration,
                                          self.items_per_batch, step, hp, False,
                                          phi_sums=svi_sums, shard=self._shard)
            stop = False
            if self.check_every > 0 and ((i + 1) % self.check_every) == 0:
                with stats.phase("metric_checks"):
                    stop, last_crit, Theta_prev = self._evaluate_criterion(
                        state, i + 1, last_crit, Theta_prev, colsums(state))
            xa = {}
            if users_numeration is not None:
                xa["users_numeration"] = users_numeration
            if items_numeration is not None:
                xa["items_numeration"] = items_numeration
            self._maybe_checkpoint(state, i + 1, rng=rng, last_crit=last_crit,
                                   extra_arrays=xa)
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
        user-side ELL layout, or on the blocked-COO training stream, or in a
        table-sharded fit on the rank's users with Beta on the ring (K13c),
        with the colsums that ``colsums()`` gives.  A table-sharded fit's
        validation check reads the real rows in their original order
        (gathered: JAX reads its padded, permuted rows there instead)."""
        from ..ops.metrics import (_train_llk, ell_train_llk_rmse, train_llk_rmse,
                                   val_llk_rmse)

        ts = self._table_shard
        gather = self._exchanges().partials
        if use_val and self._val is not None:
            Theta, Beta = self._real_factors(state)
            llk, rmse = val_llk_rmse(Theta, Beta, self._val.data, self._val.nnz,
                                     self.full_llk, gather)
            return llk, rmse, "val"
        Theta = state.G_shp / state.G_rte
        Beta = state.L_shp / state.L_rte
        theta_colsum, beta_colsum = colsums()
        if ts is not None:
            from ..parallel.table_sharded import table_sharded_llk_parts

            parts = table_sharded_llk_parts(ts.mesh, Theta, Beta, ts.u, self.full_llk)
            llk, rmse = _train_llk(gather(parts), self._nnz, theta_colsum, beta_colsum)
        elif self._metric_ell is not None:
            llk, rmse = ell_train_llk_rmse(Theta, Beta, self._metric_ell, self._nnz,
                                           theta_colsum, beta_colsum, self.full_llk, gather)
        else:
            llk, rmse = train_llk_rmse(Theta, Beta, self._metric_coo, self._nnz,
                                       theta_colsum, beta_colsum, self.full_llk, gather)
        return llk, rmse, "train"

    def _evaluate_criterion(self, state, it, last_crit, Theta_prev, colsums):
        """One convergence check (reference ``assess_convergence``,
        ``cython_loops.pxi:51-92``).  Returns (stop, last_crit, Theta_prev)."""
        from ..ops.metrics import theta_diff_norm

        if self.stop_crit == 'diff-norm':
            Theta = state.G_shp / state.G_rte
            norm = theta_diff_norm(Theta, Theta_prev, None if self._table_shard is None
                                   else self._exchanges().partials)
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
            Theta, Beta = self._real_factors(state)
            parts = self._exchanges().partials(
                llk_rmse_sums(Theta, Beta, self._val.data, self.full_llk)).cpu().numpy()
            dev = Theta.device
            corr = rowsum_dot_rows(Theta, Beta, torch.from_numpy(self._val.iu).to(dev),
                                   torch.from_numpy(self._val.ii).to(dev))
            llk = float(parts[:, 0].sum()) - corr
            rmse = float(np.sqrt(parts[:, 1].sum() / self._val.nnz))
        else:
            llk, rmse, _ = self._criterion_metric(state, colsums)
        self._last_llk, self._last_rmse = llk, rmse
        self.train_llk = llk

    def _save_parameters(self, state):
        """End-of-fit CSV export, the reference's file set and format
        (``cython_loops.pxi:44-49, 408-411``)."""
        if self.verbose:
            print("Saving final parameters to .csv files...")
        G_shp, G_rte, L_shp, L_rte, k_rte, t_rte = (_to_host(a) for a in state)
        names = ["Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp",
                 "Lambda_rte", "kappa_rte", "tau_rte"]
        objs = [G_shp / G_rte, L_shp / L_rte, G_shp, G_rte, L_shp, L_rte, k_rte, t_rte]
        for name, obj in zip(names, objs):
            np.savetxt(os.path.join(self.save_folder, name), obj, fmt="%.10f", delimiter=',')

    def _store_metadata(self, pdata):
        """Seen-items CSR for ``topN(exclude_seen=True)`` (reference
        ``_store_metadata``, ``hpfrec/__init__.py:587-606``)."""
        indptr, indices, _ = data_utils.build_csr(
            pdata.ix_u, pdata.ix_i, pdata.y, self.nusers, self.nitems)
        self._n_seen_by_user = (indptr[1:] - indptr[:-1]).astype(np.int64)
        self._st_ix_user = indptr[:-1]
        self.seen = indices

    # ------------------------------------------------------------------
    # serving
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
        """Host einsum for small batches; 65,536 pairs or more go to the
        model's device through K11 (reference ``predict_multiple``,
        ``pxi:803-810``)."""
        if iu.shape[0] >= 65536:
            from ..ops.ell import _upload
            from ..ops.metrics import predict_pairs

            dev = self._torch_device()
            return predict_pairs(_host_to_device(self.Theta, dev), self._beta_device(),
                                 _upload(iu, np.int32, dev),
                                 _upload(ii, np.int32, dev)).cpu().numpy()
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

    def _beta_cached(self, attr, make):
        """A value derived from ``Beta`` (``make(Beta)``), cached in
        ``attr`` across calls.  Invalidation: identity (a held reference),
        shape, dtype and a 1024-element strided fingerprint; every library
        path reassigns ``Beta``.  Only a table the model allocated itself is
        cached, and it is made read-only; for a caller's table the value is
        made anew on every call."""
        B = self.Beta
        arr = np.asarray(B)
        sample = arr.ravel()[:: max(1, arr.size // 1024)][:1024]
        key = (arr.shape, str(arr.dtype), sample.tobytes())
        cached = getattr(self, attr)
        if cached is not None and cached[2] is B and cached[0] == key:
            return cached[1]
        value = make(arr)
        if self._is_owned("Beta"):
            setattr(self, attr, (key, value, B))
            self._freeze_owned(("Beta",))
        else:
            setattr(self, attr, None)
        return value

    def _beta_device(self):
        """``Beta`` on the model's device for batch serving, cached across
        calls (re-uploading the (nI, k) table, 75 MB at the MillionSong
        shape, would dominate a ``topN_batch`` call)."""
        dev = self._torch_device()
        cached = self._beta_dev_cache
        if cached is not None and cached[1].device != dev:
            self._beta_dev_cache = None
        return self._beta_cached("_beta_dev_cache", lambda B: _host_to_device(B, dev))

    def _beta_colsum(self):
        """The host column sum of ``Beta`` that the fold-in's init reads,
        cached as ``_beta_device`` is (one pass over 75 MB at the
        MillionSong shape would otherwise dominate ``predict_factors``)."""
        return self._beta_cached("_beta_colsum_cache", lambda B: B.sum(axis=0))

    def topN_batch(self, users, n=10, exclude_seen=True):
        """Top-N for many users in one call: K6 scores chunks of the batch
        against the whole catalog on the device, masks the seen items and
        selects the n best (no reference analogue; its ``topN`` is one
        host gemv per user).  Returns an ``(len(users), n)`` array of item
        ids (original ids when ``reindex=True``)."""
        from ..ops.topk import topn_batch

        assert self.is_fitted
        users = np.asarray(users).reshape(-1)
        if self.reindex:
            rows = self._map_ids(users, self.user_mapping_, None)
            if (rows == -1).any():
                raise ValueError("Can only predict for users who were in the training set.")
        else:
            rows = users.astype(np.int64)
        if exclude_seen and not self.keep_data:
            raise Exception("Can only exclude seen items when passing 'keep_data=True' to .fit")
        Beta_dev = self._beta_device()
        if exclude_seen:
            idx = topn_batch(self.Theta, Beta_dev, rows, n,
                             seen_indptr=self._st_ix_user, seen_indices=self.seen,
                             n_seen=self._n_seen_by_user)
        else:
            idx = topn_batch(self.Theta, Beta_dev, rows, n)
        if self.reindex:
            return self.item_mapping_[idx]
        return idx

    # ------------------------------------------------------------------
    # online updates
    # ------------------------------------------------------------------
    @staticmethod
    def _batch_triplets(counts_df, dt):
        """(UserId, ItemId, Count) of a ``partial_fit`` batch: an (n, >=3)
        ndarray, or a DataFrame when pandas is installed."""
        if isinstance(counts_df, np.ndarray):
            assert counts_df.ndim == 2 and counts_df.shape[1] >= 3
            u, i, y = counts_df[:, 0], counts_df[:, 1], counts_df[:, 2]
        else:
            pd = data_utils._pandas()
            assert pd is not None and isinstance(counts_df, pd.DataFrame)
            for col in ("UserId", "ItemId", "Count"):
                assert col in counts_df.columns
            u, i, y = (counts_df[c].to_numpy() for c in ("UserId", "ItemId", "Count"))
        assert y.shape[0] > 0
        req = ["ENSUREARRAY", "C_CONTIGUOUS"]
        return (np.require(u, dtype=np.int64, requirements=req),
                np.require(i, dtype=np.int64, requirements=req),
                np.require(y, dtype=dt, requirements=req))

    def partial_fit(self, counts_df, batch_type='users', step_size=None,
                    nusers=None, nitems=None, users_in_batch=None, items_in_batch=None,
                    new_users=False, new_items=False, random_seed=None):
        """One SVI update from a user- or item-batch of triplets.  Mirrors
        reference ``HPF.partial_fit`` (``hpfrec/__init__.py:714-931``) and
        ``hpfrec_tpu``, including their quirks: the activity/popularity
        scalers are blended on all rows, the multiplier is
        ``nusers / len(users_in_batch)`` for item batches too, and the
        ``new_users`` / ``new_items`` growth follows the reference formulas
        verbatim.  On the device: K3 derive, K7 phi sums over every row the
        batch touches, the declared rows' masks, K8 blend
        (``ops.svi.svi_batch_update``); the state stays cached on the
        device for the next call.  With a ``mesh``, every rank calls it with
        the same batch, and K7 runs on the rank's share of its rows
        (K12b)."""
        from ..ops.ell import _upload
        from ..ops.svi import build_row_mask, svi_batch_update

        if self.reindex:
            raise ValueError("'partial_fit' can only be called when using reindex=False.")
        if not self.keep_all_objs:
            raise ValueError("'partial_fit' can only be called when using keep_all_objs=True.")
        if self.keep_data:
            if hasattr(self, "seen"):
                warnings.warn(
                    "When using 'partial_fit', the list of items seen by each user is not "
                    "updated with the data passed here.")
            else:
                warnings.warn(
                    "When fitting the model through 'partial_fit' without calling 'fit' "
                    "beforehand, 'keep_data' will be forced to False.")
                self.keep_data = False

        assert batch_type in ('users', 'items')
        user_batch = batch_type == 'users'

        if nusers is None:
            nusers = getattr(self, "nusers", None)
            if nusers is None:
                raise ValueError(
                    "Must specify total number of users when calling 'partial_fit' for the first time.")
        if nitems is None:
            nitems = getattr(self, "nitems", None)
            if nitems is None:
                raise ValueError(
                    "Must specify total number of items when calling 'partial_fit' for the first time.")
        if getattr(self, "nusers", None) is None:
            self.nusers = nusers
        if getattr(self, "nitems", None) is None:
            self.nitems = nitems

        # step-size fallback chain (reference __init__.py:834-849)
        if step_size is None:
            try:
                self.step_size(0)
                try:
                    step_size = self.step_size(self.niter)
                except Exception:
                    self.niter = 0
                    step_size = 1.0
            except Exception:
                try:
                    step_size = 1 / np.sqrt(self.niter + 2)
                except Exception:
                    self.niter = 0
                    step_size = 1.0
        assert 0 <= step_size <= 1

        if random_seed is not None:
            if isinstance(random_seed, float):
                random_seed = int(random_seed)
            assert isinstance(random_seed, int)

        dt = self._dtype
        ix_u_batch, ix_i_batch, Y_batch = self._batch_triplets(counts_df, dt)
        if users_in_batch is None:
            users_in_batch = np.unique(ix_u_batch)
        else:
            users_in_batch = np.require(users_in_batch, dtype=np.int64,
                                        requirements=["ENSUREARRAY", "C_CONTIGUOUS"])
        if items_in_batch is None:
            items_in_batch = np.unique(ix_i_batch)
        else:
            items_in_batch = np.require(items_in_batch, dtype=np.int64,
                                        requirements=["ENSUREARRAY", "C_CONTIGUOUS"])

        hp = self._hp()
        if (self.Theta is None) or (self.Beta is None):
            state = initialize_state(
                self.nusers, self.nitems, hp,
                self._agreed_seed(self.random_seed if self.random_seed is not None else 0), dt)
            self._state_to_host(state)

        if new_users or new_items:
            random_seed = self._agreed_seed(random_seed)
        if new_users:
            nusers_now = int(ix_u_batch.max()) + 1
            nusers_add = self.nusers - nusers_now
            if nusers_add < 1:
                raise ValueError("There are no new users in the data passed to 'partial_fit'.")
            new_shp, new_rte, new_scaler = initialize_extra_rows(
                nusers_add, self.a_prime, self.b_prime, self.k, random_seed, dt)
            self._own("k_rte", np.r_[self.k_rte, new_scaler])
            self._own("Theta", np.r_[self.Theta, new_shp / new_rte])
            self._own("Gamma_rte", np.r_[self.Gamma_rte, new_rte])
            self._own("Gamma_shp", np.r_[self.Gamma_shp, new_shp])
            self.nusers += nusers_add

        if new_items:
            nitems_now = int(ix_i_batch.max()) + 1
            nitems_add = self.nitems - nitems_now
            if nitems_add < 1:
                raise ValueError("There are no new items in the data passed to 'partial_fit'.")
            new_shp, new_rte, new_scaler = initialize_extra_rows(
                nitems_add, self.c_prime, self.d_prime, self.k, random_seed, dt)
            self._own("t_rte", np.r_[self.t_rte, new_scaler])
            self._own("Beta", np.r_[self.Beta, new_shp / new_rte])
            self._own("Lambda_rte", np.r_[self.Lambda_rte, new_rte])
            self._own("Lambda_shp", np.r_[self.Lambda_shp, new_shp])
            self.nitems += nitems_add

        # Reference quirk (hpfrec/__init__.py:912): the multiplier is always
        # nusers/len(users_in_batch), even for item batches; an empty user
        # list makes it undefined (an empty items_in_batch blends nothing)
        if users_in_batch.shape[0] == 0:
            raise ValueError(
                "'users_in_batch' is empty: the SVI multiplier "
                "nusers/|users_in_batch| is undefined for an empty user "
                "batch. Pass the users present in the data (or omit the "
                "argument to derive them).")
        multiplier_batch = float(nusers) / users_in_batch.shape[0]
        # the kernels index the tables with these ids: out-of-range ids
        # would write outside them
        for ids, n_rows, what in ((ix_u_batch, self.nusers, "user"),
                                  (users_in_batch, self.nusers, "user"),
                                  (ix_i_batch, self.nitems, "item"),
                                  (items_in_batch, self.nitems, "item")):
            if ids.shape[0] and (int(ids.min()) < 0 or int(ids.max()) >= n_rows):
                raise ValueError("'partial_fit' got %s ids outside 0..%d" % (what, n_rows - 1))

        state = self._state_from_host()
        dev = state.G_shp.device

        def row_mask(n_rows, rows):
            # an empty declared list blends nothing: a zero mask, no launch
            return build_row_mask(n_rows, _upload(rows, np.int32, dev))

        state = svi_batch_update(
            state, Y_batch, ix_u_batch, ix_i_batch,
            row_mask(self.nusers, users_in_batch), row_mask(self.nitems, items_in_batch),
            float(dt(step_size)), float(dt(multiplier_batch)), hp,
            user_side=user_batch, blend_all_scalers=True, phi_sums=self._exchanges().svi,
            shard=self._shard)
        self._state_to_host(state)

        self.niter = (self.niter or 0) + 1
        self.is_fitted = True
        return self

    def _check_input_predict_factors(self, ncores, random_seed, stop_thr, maxiter):
        if ncores is None:
            ncores = 1
        if ncores < 1:
            import multiprocessing

            ncores = multiprocessing.cpu_count()
        assert ncores > 0
        assert isinstance(ncores, int)
        assert isinstance(random_seed, int)
        assert random_seed > 0
        if isinstance(stop_thr, int):
            stop_thr = float(stop_thr)
        assert stop_thr > 0
        assert isinstance(stop_thr, float)
        if isinstance(maxiter, float):
            maxiter = int(maxiter)
        assert isinstance(maxiter, int)
        assert maxiter > 0
        return ncores, random_seed, stop_thr, maxiter

    def _process_data_single(self, counts_df):
        """A single user's (item rows, counts) from an (n, >=2) ndarray of
        ItemId/Count or a DataFrame with those columns (reference
        ``_process_data_single``, ``hpfrec/__init__.py:682-712``)."""
        assert self.is_fitted
        assert self.keep_all_objs
        if isinstance(counts_df, np.ndarray):
            assert len(counts_df.shape) > 1
            assert counts_df.shape[1] >= 2
            items, counts = counts_df[:, 0].copy(), counts_df[:, 1].copy()
        elif (pd := data_utils._pandas()) is not None and isinstance(counts_df, pd.DataFrame):
            assert counts_df.shape[0] > 0
            assert "ItemId" in counts_df.columns
            assert "Count" in counts_df.columns
            items, counts = counts_df["ItemId"].to_numpy(), counts_df["Count"].to_numpy()
        else:
            raise ValueError("'counts_df' must be a pandas data frame or a numpy array")
        if not self.reindex and items.shape[0] and (
                items.min() < 0 or items.max() > self.nitems - 1):
            # the fold-in and K6's mask index the item tables with these ids
            raise ValueError("Item ids must be in 0..%d (the training set's items)."
                             % (self.nitems - 1))

        if self.reindex:
            if self.produce_dicts:
                try:
                    items = np.array([self.item_dict_[x] for x in items], dtype=np.int64)
                except (KeyError, TypeError):
                    raise ValueError("Can only make calculations for items that were in the training set.")
            else:
                items = data_utils.map_to_training_ids(items, self.item_mapping_)
                if (items == -1).sum() > 0:
                    raise ValueError("Can only make calculations for items that were in the training set.")
        return items, counts

    def _fold_in_start(self, items, counts, random_seed):
        """The fold-in's host inputs, the seeded init of ``hpfrec_tpu``
        verbatim: ``(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0)``
        and ``k_rte0``, all in the state dtype."""
        from scipy.special import digamma as np_digamma

        dt = self._dtype
        k = self.k
        y = np.asarray(counts).astype(dt)
        ix_i = np.asarray(items).astype(np.int64)
        beta_colsum = self._beta_colsum().astype(dt)

        rng = np.random.default_rng(seed=random_seed if random_seed > 0 else None)
        Theta0 = rng.gamma(self.a, 1.0 / self.b_prime, size=k).astype(dt)
        G_rte0 = (rng.gamma(self.a_prime, self.b_prime / self.a_prime, size=1).astype(dt)
                  + beta_colsum)
        G_shp0 = G_rte0 * Theta0 * rng.uniform(low=0.85, high=1.15, size=k).astype(dt)
        G_shp0 = np.nan_to_num(G_shp0)
        G_rte0 = np.nan_to_num(G_rte0)
        k_rte0 = np.asarray(self.b_prime + Theta0.sum(), dtype=dt)

        elogb_rows = (np_digamma(self.Lambda_shp[ix_i]) - np.log(self.Lambda_rte[ix_i])).astype(dt)
        return (y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0), float(k_rte0)

    def _run_user_factors(self, items, counts, maxiter, random_seed, stop_thr, return_all):
        """Fold-in (reference ``calc_user_factors``, ``cython_loops.pxi:476-520``):
        the seeded host init, then K10 on the model's device with the item
        parameters frozen (one copy up and one back on the card)."""
        from ..ops.svi import fold_in

        arrays, k_rte0 = self._fold_in_start(items, counts, random_seed)
        Theta, G_shp, G_rte, phi_norm, _ = fold_in(
            *arrays, k_rte0, self._hp(), int(maxiter), float(stop_thr), self._torch_device(),
            return_phi=return_all)
        if np.isnan(Theta).sum() > 0:
            raise ValueError("NaNs encountered in the result. Failed to produce latent factors.")
        return Theta, G_shp, G_rte, phi_norm

    def predict_factors(self, counts_df, maxiter=10, ncores=1, random_seed=1,
                        stop_thr=1e-3, return_all=False):
        """Latent factors for a new user given her item counts (item
        parameters frozen), by K10.  Mirrors reference
        ``HPF.predict_factors`` (``hpfrec/__init__.py:989-1058``)."""
        ncores, random_seed, stop_thr, maxiter = self._check_input_predict_factors(
            ncores, random_seed, stop_thr, maxiter)
        items, counts = self._process_data_single(counts_df)
        Theta, G_shp, G_rte, phi = self._run_user_factors(
            items, counts, maxiter, random_seed, stop_thr, return_all)
        if return_all:
            return (Theta, G_shp, G_rte, phi)
        return Theta

    def add_user(self, user_id, counts_df, update_existing=False, maxiter=10, ncores=1,
                 random_seed=1, stop_thr=1e-3, update_all_params=None):
        """Add or update a single user (reference ``HPF.add_user``,
        ``hpfrec/__init__.py:1060-1196``): by fold-in (K10), or with
        ``update_all_params`` by repeated ``partial_fit`` on the user's
        batch (each call brings the state back to the host, as the
        reference and ``hpfrec_tpu`` do)."""
        ncores, random_seed, stop_thr, maxiter = self._check_input_predict_factors(
            ncores, random_seed, stop_thr, maxiter)

        if update_existing:
            if self.produce_dicts and self.reindex:
                user_id = self.user_dict_[user_id]
            elif self.reindex:
                user_id = data_utils.map_to_training_ids(
                    np.array([user_id]), self.user_mapping_)[0]
                if user_id == -1:
                    raise ValueError("User was not present in the training data.")

        items, counts = self._process_data_single(counts_df)

        if update_all_params:
            batch = np.column_stack([np.full(items.shape[0], user_id), items, counts])
            self.partial_fit(batch, new_users=(not update_existing))
            Theta_prev = self.Theta[-1].copy()
            for _ in range(maxiter - 1):
                self.partial_fit(batch)
                new_Theta = self.Theta[-1]
                if np.linalg.norm(new_Theta - Theta_prev) <= stop_thr:
                    break
                Theta_prev = self.Theta[-1].copy()
        else:
            Theta, G_shp, G_rte, _ = self._run_user_factors(
                items, counts, maxiter, random_seed, stop_thr, False)
            new_k_rte = self.a_prime / self.b_prime + \
                (G_shp.reshape((1, -1)) / G_rte.reshape((1, -1))).sum(axis=1, keepdims=True)
            if update_existing:
                self._unshare("Theta")
                self.Theta[user_id] = Theta
                if self.keep_all_objs:
                    # the cached host arrays are read-only: thaw them for
                    # this row edit and drop the device-state cache (the
                    # arrays keep their identity)
                    for nm in ("Gamma_shp", "Gamma_rte", "k_rte"):
                        self._unshare(nm)
                        self._thaw_attr(nm)
                    self.Gamma_shp[user_id] = G_shp
                    self.Gamma_rte[user_id] = G_rte
                    self.k_rte[user_id] = new_k_rte
                    self._dev_state_cache = None
            else:
                if self.reindex:
                    new_id = self.user_mapping_.shape[0]
                    self.user_mapping_ = np.r_[self.user_mapping_, np.array([user_id])]
                    if self.produce_dicts:
                        self.user_dict_[user_id] = new_id
                # the reference's np.r_ appends, in amortized time
                self._append_rows("Theta", Theta.reshape((1, self.k)))
                if self.keep_all_objs:
                    self._append_rows("Gamma_shp", G_shp.reshape((1, self.k)))
                    self._append_rows("Gamma_rte", G_rte.reshape((1, self.k)))
                    self._append_rows("k_rte", new_k_rte)
                self.nusers += 1

        if self.keep_data:
            items_arr = np.asarray(items).astype(self.seen.dtype, copy=False)
            if update_existing:
                self._unshare("_n_seen_by_user")
                self._unshare("_st_ix_user")
                before = self._n_seen_by_user[user_id]
                self._n_seen_by_user[user_id] = items_arr.shape[0]
                st = self._st_ix_user[user_id]
                self.seen = np.r_[self.seen[:st], items_arr, self.seen[st + before:]]
                self._st_ix_user[user_id + 1:] += self._n_seen_by_user[user_id] - before
            else:
                self._append_rows("_n_seen_by_user", np.array([items_arr.shape[0]]), own=False)
                self._append_rows("_st_ix_user", np.array([self.seen.shape[0]]), own=False)
                self._append_rows("seen", items_arr, own=False)

        return True

    def save(self, path):
        """Save the fitted model to the directory ``path``: ``model.npz`` and
        ``model.json``, the files of ``hpfrec_tpu.HPF.save``.  With a mesh,
        rank 0 writes them and every rank waits for it."""
        from ..utils.io import save_model

        self._on_rank0(lambda: save_model(self, path))
        return self

    @classmethod
    def load(cls, path, step_size=None, device="cuda"):
        """Load a model saved by :meth:`save` (of this package or of
        ``hpfrec_tpu``) onto ``device``.  ``step_size`` (a function) is not
        serialized; pass it again if you need a non-default one."""
        from ..utils.io import load_model

        return load_model(path, step_size=step_size, device=device)

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
