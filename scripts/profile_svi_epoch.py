"""Where an SVI epoch of hpfrec_tpu_torch spends its time on one CUDA card.

Run from the root of a checkout:  python3 scripts/profile_svi_epoch.py

At the MillionSong TasteProfile shape (chip_smoke.py's data, k=50,
float32, batches of 100,000 users / 40,000 items) it runs one user epoch
and one item epoch of ``ops.svi.svi_run_epoch`` as a warm-up, then:

1. the same two epochs stage by stage: a CUDA event after the epoch's
   host part (``ops.svi.epoch_order``: the offsets and their upload), then
   ``svi_run_epoch``'s ``mark`` hook records one after each stage it
   issues (K9 once per epoch; per batch: K3 derive of both sides, K7 with
   its sort, the row mask, K8), and the epoch's wall time on the host
   clock (ending in a synchronize);
2. the two epochs under ``torch.profiler``: device time by kernel name and
   the device's busy share of the window (the sum of the device-side
   events' times over the window's host-clock length; one stream, so they
   do not overlap).

Prints the card (nvidia-smi name and power limit) first.  Needs a card.
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import K, MILLIONSONG, SVI_BATCHES, holdout, powerlaw_coo  # noqa: E402


def stage_times(state, side, perm, batch_rows, hp, user_side):
    """One epoch of svi_run_epoch with a CUDA event recorded after each
    stage it issues; returns (state, {stage: ms}, wall seconds)."""
    import torch

    from hpfrec_tpu_torch.ops.svi import epoch_order, svi_run_epoch

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark("start")
    order = epoch_order(side, perm, state.G_shp.device)
    mark("host offsets + upload")
    state = svi_run_epoch(state, side, order, batch_rows, 0.4, hp, user_side, mark=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return state, out, wall


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_svi_epoch: needs a CUDA card", file=sys.stderr)
        return 1
    from hpfrec_tpu_torch import _cuda
    from hpfrec_tpu_torch.models.state import Hyperparams, initialize_state
    from hpfrec_tpu_torch.ops.svi import epoch_order, epoch_side, svi_run_epoch
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card (nvidia-smi name, power.limit):", smi)
    _cuda.load()
    dev = torch.device("cuda")
    train, _ = holdout(powerlaw_coo(**MILLIONSONG, seed=0), 0.01, seed=5)
    p = process_data(train, "val-llk", False, np.float32)
    hp = Hyperparams(k=K)
    state = initialize_state(p.nusers, p.nitems, hp, 1, np.float32, dev)
    side_u = epoch_side(*build_csr(p.ix_u, p.ix_i, p.y, p.nusers, p.nitems), np.float32, dev)
    side_i = epoch_side(*build_csr(p.ix_i, p.ix_u, p.y, p.nitems, p.nusers), np.float32, dev)
    rng = np.random.default_rng(1)
    epochs = ((side_u, SVI_BATCHES["users_per_batch"], True, "user"),
              (side_i, SVI_BATCHES["items_per_batch"], False, "item"))
    for side, rows, user_side, _ in epochs:  # warm-up
        state = svi_run_epoch(state, side, epoch_order(side, rng.permutation(side.n_rows), dev),
                              rows, 0.5, hp, user_side)
    torch.cuda.synchronize()

    print("nonzeros %d, k=%d, float32, batches %s" % (p.y.shape[0], K, SVI_BATCHES))
    for side, rows, user_side, name in epochs:
        perm = rng.permutation(side.n_rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = svi_run_epoch(state, side, epoch_order(side, perm, dev), rows, 0.4, hp,
                              user_side)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        state, stages, wall = stage_times(state, side, perm, rows, hp, user_side)
        total = sum(stages.values())
        print("%s epoch: %.2f ms wall (svi_run_epoch), %.2f ms wall with stage events; "
              "stages (device ms, share of the evented wall):"
              % (name, plain_wall * 1e3, wall * 1e3))
        for stage, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
            print("  %-30s %8.3f ms  %5.1f%%" % (stage, ms, 100 * ms / (wall * 1e3)))
        print("  %-30s %8.3f ms" % ("sum of stages", total))

    from torch.profiler import ProfilerActivity, profile

    perms = [rng.permutation(side.n_rows) for side, _, _, _ in epochs]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for (side, rows, user_side, _), perm in zip(epochs, perms):
            state = svi_run_epoch(state, side, epoch_order(side, perm, dev), rows, 0.3, hp,
                                  user_side)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): a host op's self
    # device time repeats its kernels' time
    rows = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    print("torch.profiler, one user + one item epoch: window %.2f ms (host clock), device "
          "busy %.2f ms (%.1f%%), idle %.1f%%"
          % (window * 1e3, busy, 100 * busy / (window * 1e3), 100 - 100 * busy / (window * 1e3)))
    for ms, count, key in sorted(rows, reverse=True)[:20]:
        print("  %9.3f ms  %5d x  %s" % (ms, count, key[:110]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
