"""Small versions of the benchmark's cells for CPU tests: the published
widths kept where a test can hold them, the scale cut."""

from hpfbench import spec

SIZES = {
    "tasteprofile-k50": dict(n_users=600, n_items=400, nnz=9000, k=8),
    "movielens20m-k30": dict(n_users=300, n_items=200, nnz=9000, k=6),
    # the serving cell at its width k=50, over enough items for near ties
    "tasteprofile-k50.topn-candidates": dict(n_users=16384, n_items=30000, nnz=60000, k=50),
}
TRAFFIC = {
    "topn-candidates": dict(users_per_call=4096, check_users=16384),
}


# cells whose files are ready under hpfbench/ but which BENCHMARK.json does
# not list (PERF.md, Open questions): tested here as the listed ones are
SPARE = [{"name": "movielens20m-k30.cavi-20", "config": "movielens20m-k30",
          "traffic": "cavi-20", "chips": 1}]


def workload(name):
    for w in spec.load_spec()["workloads"] + SPARE:
        if w["name"] == name:
            return w
    raise KeyError(name)


def config(name, workload=None):
    return dict(spec.config(name), **SIZES.get(workload, SIZES[name]))


def traffic(name):
    return dict(spec.traffic(name), **TRAFFIC.get(name, {}))
