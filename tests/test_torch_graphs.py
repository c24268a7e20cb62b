"""The graph cache of the map's steps (kernels/graphs.py) on the CPU: its
keys, its one table set per device (uploaded into in place for the same
shapes, dropped with every graph for others), ``clear``, a replay's
copies in and out, and the CPU route, which runs the eager steps and captures nothing
while the map writes the JAX package's PAF. Capture and replay on a card
are held against the eager steps in tests/test_torch_cuda.py."""

import os
import sys

import numpy as np
import pytest
import torch

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.params import Parameters as JaxParameters
from mashmap_tpu_torch.api import map_files
from mashmap_tpu_torch.kernels import graphs
from mashmap_tpu_torch.kernels.mapdev import L1Config, l1_step, l2_step
from mashmap_tpu_torch.params import Parameters

sys.path.insert(0, os.path.dirname(__file__))
from genomes import mutate, pangenome, write_fasta  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

CFG = L1Config(k=11, s=30, seg_length=500)
CPU = torch.device("cpu")


class _Owner:
    """Stands for a Mapper: any object a weakref can name."""


def _arrays(n=50, seed=0, names=("uniq_flip", "mi_rank")):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 1000, n).astype(np.int64) for k in names}


def _cache():
    c = graphs._DeviceCache(CPU)
    owner = _Owner()
    return c, owner, c.bind(owner, _arrays())


def test_key_reads_shapes_dtypes_config_and_table_names():
    c, _, t = _cache()
    frags = np.zeros((8, 500), np.uint8)
    key = c.key(l1_step, (frags, t["uniq_flip"]), (CFG,))
    # same shapes, other values: the same key
    assert key == c.key(l1_step, (np.ones((8, 500), np.uint8),
                                  t["uniq_flip"]), (CFG,))
    others = [
        c.key(l1_step, (np.zeros((12, 500), np.uint8), t["uniq_flip"]),
              (CFG,)),
        c.key(l1_step, (frags.astype(np.int8), t["uniq_flip"]),
              (CFG,)),
        c.key(l1_step, (frags, t["uniq_flip"]),
              (CFG._replace(p_cap=2048),)),
        c.key(l2_step, (frags, t["uniq_flip"]), (CFG,)),
        # a table by its name, not by its shape
        c.key(l1_step, (frags, t["mi_rank"]), (CFG,)),
        c.key(l1_step, (frags, t["uniq_flip"].clone()), (CFG,)),
    ]
    assert len({key, *others}) == 1 + len(others)
    assert c.key(l2_step, (frags,), (512, 30)) != c.key(
        l2_step, (frags,), (1024, 30))


def test_same_table_shapes_upload_in_place_and_keep_graphs():
    c, a, t = _cache()
    c.graphs["g"] = "a graph"
    b = _Owner()
    new = _arrays(seed=1)
    t2 = c.bind(b, new)
    assert all(t2[k] is t[k] for k in t)           # no second copy
    for k in new:
        np.testing.assert_array_equal(t2[k].numpy(), new[k])
    assert c.graphs == {"g": "a graph"}
    # the owner's own contents are not uploaded again
    t2["mi_rank"][0] = -1
    c.bind(b, new)
    assert int(t2["mi_rank"][0]) == -1
    # another owner's are, and a dead owner's contents count as another's
    c.bind(a, _arrays())
    np.testing.assert_array_equal(t["mi_rank"].numpy(),
                                  _arrays()["mi_rank"])
    del a
    t["mi_rank"][0] = -1
    c.bind(b, new)
    np.testing.assert_array_equal(t["mi_rank"].numpy(), new["mi_rank"])


@pytest.mark.parametrize("change", ["shape", "dtype", "names"])
def test_other_table_shapes_drop_every_graph_and_the_pool(change):
    c, owner, t = _cache()
    c.graphs["g"] = "a graph"
    c.pool = "a pool"
    if change == "shape":
        new = _arrays(n=51)
    elif change == "dtype":
        new = {k: a.astype(np.int32) for k, a in _arrays().items()}
    else:
        new = _arrays(names=("uniq_flip", "mi_wpos"))
    t2 = c.bind(owner, new)
    assert c.graphs == {} and c.pool is None
    assert set(t2) == set(new) and all(x is not t.get(k)
                                       for k, x in t2.items())
    assert set(c.names.values()) == set(new)
    frags = np.zeros((8, 500), np.uint8)
    assert c.key(l1_step, (frags, t2["uniq_flip"]), ())[3][1] == (
        "table", "uniq_flip")
    assert c.key(l1_step, (frags, t["uniq_flip"]), ())[3][1] == (
        (50,), str(t["uniq_flip"].dtype))


def test_replay_copies_inputs_in_and_outputs_out():
    """A replay copies each non-table argument into its static input and
    each static output into a fresh tensor: two replays in a row give
    each call's own result, and a table is read in place."""
    table = torch.arange(10, dtype=torch.int64)

    def step(x, tab, y):
        return (x * 2 + tab[:4], y + 1)

    args = (np.arange(4, dtype=np.int64), table, torch.zeros(3))
    inputs = [torch.from_numpy(args[0].copy()), None, args[2].clone()]
    outputs = step(inputs[0], table, inputs[2])

    class Recorded:
        """Runs the step on the static tensors into the static outputs,
        as a replay of its capture does."""

        def replay(self):
            for so, o in zip(outputs, step(inputs[0], table, inputs[2])):
                so.copy_(o)

    g = graphs._Graph(Recorded(), inputs, outputs)
    x1, x2 = np.full(4, 5, np.int64), np.full(4, 7, np.int64)
    y1, y2 = torch.ones(3), torch.full((3,), 4.0)
    r1 = g.replay((x1, table, y1))
    r2 = g.replay((x2, table, y2))
    for got, x, y in ((r1, x1, y1), (r2, x2, y2)):
        want = step(torch.from_numpy(x), table, y)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(got, outputs))


def test_clear_drops_a_device_cache_or_all():
    """clear(device) drops that device's table set, graphs and pool and
    forgets its cache; clear() does so for every device."""
    owner = _Owner()
    caches = {CPU: graphs._DeviceCache(CPU),
              torch.device("meta"): graphs._DeviceCache(CPU)}
    for c in caches.values():
        c.bind(owner, _arrays())
        c.graphs["g"] = "a graph"
        c.pool = "a pool"
    graphs._CACHES.update(caches)
    try:
        graphs.clear("cpu")
        assert list(graphs._CACHES) == [torch.device("meta")]
        a = caches[CPU]
        assert (a.graphs, a.tables, a.names, a.pool, a.sig) == (
            {}, {}, {}, None, None)
        assert caches[torch.device("meta")].graphs == {"g": "a graph"}
        graphs.clear()
        assert graphs._CACHES == {}
        assert all(c.tables == {} and c.pool is None
                   for c in caches.values())
    finally:
        graphs._CACHES.clear()


def test_cpu_call_runs_the_step_and_captures_nothing():
    graphs.reset_counts()
    got = graphs.call("cpu", lambda a, b, k: a + b + k,
                      (np.arange(3), torch.ones(3, dtype=torch.int64)), 2)
    assert torch.equal(got, torch.tensor([3, 4, 5]))
    assert graphs.tables("cpu", _Owner(), {"x": np.arange(2)})[
        "x"].tolist() == [0, 1]
    assert graphs.CAPTURES == {} and graphs.REPLAYS == {}
    assert graphs._CACHES == {}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    recs = pangenome(3, 12_000, divergence=0.05, seed=41)
    queries = [("q_a", mutate(recs[0][1][1_000:5_300], 0.03, seed=42)),
               ("q_b", mutate(recs[2][1][4_000:9_900], 0.02, seed=43))]
    ref, qf = str(d / "ref.fa"), str(d / "q.fa")
    write_fasta(ref, recs)
    write_fasta(qf, queries)
    return ref, qf


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_cpu_map_captures_nothing_and_equals_jax(pair, tmp_path,
                                                 monkeypatch, devices):
    """map_files on the CPU sends every l1_step and l2_step call of the
    replicated path through graphs.call, one call per row block, runs
    them eagerly (nothing captured, nothing cached), and writes the JAX
    package's PAF."""
    ref, qf = pair
    kw = dict(ref_sequences=[ref], query_sequences=[qf], kmer_size=11,
              seg_length=500, sketch_size=30, percentage_identity=0.80,
              batch_fragments=8, no_progress=True)
    jax_map_files(JaxParameters(out_file_name=str(tmp_path / "jax.paf"),
                                **kw))
    calls = {}
    real = graphs.call

    def spy(device, step, args, *static):
        assert torch.device(device).type == "cpu"
        calls[step.__name__] = calls.get(step.__name__, 0) + 1
        return real(device, step, args, *static)
    monkeypatch.setattr(graphs, "call", spy)
    graphs.reset_counts()
    out = str(tmp_path / "port.paf")
    map_files(Parameters(out_file_name=out, **kw), devices=devices)
    assert calls["l1_step"] >= 3 * len(devices)
    assert calls["l1_step"] % len(devices) == 0
    assert calls["l2_step"] >= len(devices)
    assert graphs.CAPTURES == {} and graphs.REPLAYS == {}
    assert graphs._CACHES == {}
    with open(tmp_path / "jax.paf") as fh:
        want = fh.read()
    with open(out) as fh:
        assert fh.read() == want
    assert want.count("\n") >= 2
