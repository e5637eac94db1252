"""Checkpointing, model serialization and the CSV of the id mappings.

A copy of ``hpfrec_tpu/utils/io.py`` with the same file names, array keys
(the six state arrays, ``x_`` + the name of each extra loop array), meta
keys and rng encoding, so that each package reads the other's checkpoint
and model files: a resumable checkpoint (the six variational arrays, the
iteration counter and the SVI shuffle-rng state) written during a fit, and
dependency-free whole-model save/load (the step-size function is not
stored; the caller passes it again).  Arrays come back as host numpy; the
fit moves them to its device.  ``series_csv`` writes a mapping as
``pandas.Series(values).to_csv(path, index=False)`` does, without pandas.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pickle
from typing import Optional

import numpy as np

CHECKPOINT_FILE = "checkpoint.npz"
CHECKPOINT_META = "checkpoint.json"
MODEL_FILE = "model.npz"
MODEL_META = "model.json"

_STATE_KEYS = ("G_shp", "G_rte", "L_shp", "L_rte", "k_rte", "t_rte")


def _host(a) -> np.ndarray:
    """A numpy copy of a host array or a tensor on any device."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(folder: str, state, niter: int, rng=None,
                    extra: Optional[dict] = None,
                    extra_arrays: Optional[dict] = None) -> None:
    """Atomically write a resumable training checkpoint.

    ``extra_arrays`` carries trainer-loop state beyond the model (e.g. the
    SVI epoch permutation arrays, which the shuffle mutates in place)."""
    os.makedirs(folder, exist_ok=True)
    arrays = {k: _host(getattr(state, k)) for k in _STATE_KEYS}
    if extra_arrays:
        for k, v in extra_arrays.items():
            arrays["x_" + k] = np.asarray(v)
    tmp = os.path.join(folder, "_tmp_" + CHECKPOINT_FILE)  # savez appends .npz to bare names
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(folder, CHECKPOINT_FILE))
    meta = {"niter": int(niter)}
    if extra:
        meta.update(extra)
    if rng is not None:
        meta["rng_state"] = _encode_rng(rng)
    tmp = os.path.join(folder, CHECKPOINT_META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(folder, CHECKPOINT_META))


def load_checkpoint(folder: str):
    """Returns (state of host arrays, meta, rng_or_None)."""
    from ..models.state import VariationalState

    with np.load(os.path.join(folder, CHECKPOINT_FILE)) as z:
        state = VariationalState(*(z[k] for k in _STATE_KEYS))
        extra_arrays = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    with open(os.path.join(folder, CHECKPOINT_META)) as f:
        meta = json.load(f)
    rng = None
    if "rng_state" in meta:
        rng = _decode_rng(meta.pop("rng_state"))
    meta["extra_arrays"] = extra_arrays
    return state, meta, rng


def has_checkpoint(folder: Optional[str]) -> bool:
    return bool(folder) and os.path.exists(os.path.join(folder, CHECKPOINT_FILE)) \
        and os.path.exists(os.path.join(folder, CHECKPOINT_META))


def _encode_rng(rng: np.random.Generator) -> str:
    import base64

    return base64.b64encode(pickle.dumps(rng.bit_generator.state)).decode()


def _decode_rng(s: str) -> np.random.Generator:
    import base64

    rng = np.random.default_rng()
    rng.bit_generator.state = pickle.loads(base64.b64decode(s.encode()))
    return rng


# ----------------------------------------------------------------------
# whole-model serialization
# ----------------------------------------------------------------------
_MODEL_SCALARS = (
    "k", "a", "a_prime", "b_prime", "c", "c_prime", "d_prime", "ncores",
    "stop_crit", "check_every", "stop_thr", "users_per_batch",
    "items_per_batch", "maxiter", "use_float", "reindex", "verbose",
    "random_seed", "allow_inconsistent_math", "full_llk", "alloc_full_phi",
    "keep_data", "produce_dicts", "keep_all_objs", "sum_exp_trick",
    "is_fitted", "niter", "train_llk", "nusers", "nitems",
)
_MODEL_ARRAYS = (
    "Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
    "k_rte", "t_rte", "user_mapping_", "item_mapping_",
    "seen", "_st_ix_user", "_n_seen_by_user",
)
# arrays a loaded model owns, as a fitted one does (cached on the device)
_OWNED = ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
          "k_rte", "t_rte")


def save_model(model, path: str) -> None:
    """Save a fitted HPF model to ``path`` (a directory).  An attribute that
    ``add_user`` grew is a leading view of a buffer with spare rows: only
    its own rows are written."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for name in _MODEL_ARRAYS:
        val = getattr(model, name, None)
        if val is not None:
            arrays[name] = np.asarray(val)
    np.savez(os.path.join(path, MODEL_FILE), **arrays)
    meta = {}
    for name in _MODEL_SCALARS:
        val = getattr(model, name, None)
        if isinstance(val, (np.integer,)):
            val = int(val)
        elif isinstance(val, (np.floating,)):
            val = float(val)
        meta[name] = val
    with open(os.path.join(path, MODEL_META), "w") as f:
        json.dump(meta, f)


def load_model(path: str, step_size=None, device="cuda"):
    """Load a model saved by ``save_model`` (of either package) as the
    port's ``HPF`` on ``device``.  ``step_size`` may be re-supplied
    (functions are not serialized); defaults to the package default
    schedule 1/sqrt(x+2)."""
    from ..models.hpf import HPF

    with open(os.path.join(path, MODEL_META)) as f:
        meta = json.load(f)
    kwargs = dict(
        k=meta["k"], a=meta["a"], a_prime=meta["a_prime"], b_prime=meta["b_prime"],
        c=meta["c"], c_prime=meta["c_prime"], d_prime=meta["d_prime"],
        ncores=meta["ncores"], stop_crit=meta["stop_crit"],
        check_every=meta["check_every"] or None, stop_thr=meta["stop_thr"],
        users_per_batch=meta["users_per_batch"] or None,
        items_per_batch=meta["items_per_batch"] or None,
        maxiter=meta["maxiter"], use_float=meta["use_float"],
        reindex=meta["reindex"], verbose=meta["verbose"],
        random_seed=meta["random_seed"],
        allow_inconsistent_math=meta["allow_inconsistent_math"],
        full_llk=meta["full_llk"], alloc_full_phi=meta["alloc_full_phi"],
        keep_data=meta["keep_data"], produce_dicts=meta["produce_dicts"],
        keep_all_objs=meta["keep_all_objs"], sum_exp_trick=meta["sum_exp_trick"],
        device=device,
    )
    if step_size is not None:
        kwargs["step_size"] = step_size
    model = HPF(**kwargs)
    # constructor may coerce these; restore the saved truth
    model.reindex = meta["reindex"]
    model.produce_dicts = meta["produce_dicts"]
    model.is_fitted = meta["is_fitted"]
    model.niter = meta["niter"]
    model.train_llk = meta["train_llk"]
    model.nusers = meta["nusers"]
    model.nitems = meta["nitems"]
    with np.load(os.path.join(path, MODEL_FILE), allow_pickle=True) as z:
        for name in _MODEL_ARRAYS:
            if name in z:
                if name in _OWNED:
                    model._own(name, z[name])
                else:
                    setattr(model, name, z[name])
    if model.produce_dicts and getattr(model, "user_mapping_", None) is not None:
        model.user_dict_ = {model.user_mapping_[i]: i
                            for i in range(model.user_mapping_.shape[0])}
        model.item_dict_ = {model.item_mapping_[i]: i
                            for i in range(model.item_mapping_.shape[0])}
    return model


# ----------------------------------------------------------------------
# CSV of an id mapping
# ----------------------------------------------------------------------
def _csv_field(v) -> str:
    """A value as pandas writes it in a CSV cell: missing values (None,
    NaN) as the empty string, anything else as ``str``."""
    if v is None or (isinstance(v, (float, np.floating)) and math.isnan(v)):
        return ""
    return str(v)


def series_csv(path: str, values) -> None:
    """Write ``values`` (1-D) byte for byte as
    ``pandas.Series(values).to_csv(path, index=False)``: a header line
    ``0``, one value a line, QUOTE_MINIMAL quoting, ``\\n`` line ends."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        writer.writerow(["0"])
        writer.writerows([_csv_field(v)] for v in np.asarray(values).reshape(-1))
