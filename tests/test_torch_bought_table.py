"""The already-bought table a request serves (``inference.bought_table``):
the ``bought-by`` relation's padded rows where they hold the host pack's
table bit for bit, the host pack (``build_padded_pair_set``) elsewhere.
No JAX: the host pack of the same graph is the reference."""

import numpy as np
import pytest
import torch

from gnn_recsys_tpu_torch import inference
from gnn_recsys_tpu_torch.graph.hetero import build_hetero_graph
from gnn_recsys_tpu_torch.graph.serialize import load_graph, save_graph
from gnn_recsys_tpu_torch.inference import (BOUGHT_BY, BUYS, already_bought_from_graph,
                                            bought_table)
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data
from portbench.drivers import ondemand
from portbench.harness import data as bdata


def _packed(graph):
    return build_padded_pair_set(*already_bought_from_graph(graph),
                                 num_src=graph.num_nodes("user"))


def _routes():
    return bought_table.from_graph, bought_table.packed


def _graph(buys_u, buys_i, num_users, num_items, max_fanout=32, reverse=True, **kw):
    """Purchases as ``buys``, their swap as ``bought-by`` unless ``reverse``
    is False (or a pair of arrays: the reverse COO itself)."""
    schema = {BUYS: (buys_u, buys_i)}
    if reverse is True:
        schema[BOUGHT_BY] = (buys_i, buys_u)
    elif reverse is not False:
        schema[BOUGHT_BY] = reverse
    return build_hetero_graph(schema, {"user": num_users, "item": num_items},
                              max_fanout=max_fanout, **kw)


def _cell_like(per_user):
    """The serving cell's generator at a small size: ``bought-by`` the
    purchases swapped, rows capped at 32."""
    gd = bdata.make_graph(dict(num_users=500, num_items=150, num_groups=8,
                               interactions_per_user=per_user, test_per_user=2,
                               in_group_prob=0.9, feat_dim=8), seed=2**33 + 5)
    return build_hetero_graph(gd["schema"], gd["num_nodes"], edata=gd["edata"],
                              ndata=gd["ndata"], max_fanout=32)


def _ragged():
    """0 to 16 purchases a user, in a shuffled (time) order."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 17, size=300)
    buys_u = rng.permutation(np.repeat(np.arange(300), counts)).astype(np.int32)
    buys_i = rng.integers(0, 90, size=buys_u.size).astype(np.int32)
    return _graph(buys_u, buys_i, 300, 90)


def _serving_fixture(tmp_path):
    """The serving tests' port graph, saved and loaded as a request loads it."""
    path = str(tmp_path / "graph.npz")
    save_graph(make_synthetic_data(num_users=200, num_items=100, seed=7).graph, path)
    return load_graph(path)


GRAPHS = {
    "serving_fixture": _serving_fixture,
    "serving_fixture_in_memory": lambda _: make_synthetic_data(
        num_users=200, num_items=100, seed=7).graph,
    "cell_like_10": lambda _: _cell_like(10),
    "cell_like_16": lambda _: _cell_like(16),
    "ragged": lambda _: _ragged(),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bought_table_takes_the_graph_rows(name, tmp_path):
    graph = GRAPHS[name](tmp_path)
    want = _packed(graph)
    before = _routes()
    got = bought_table(graph)
    assert _routes() == (before[0] + 1, before[1])
    assert got.rows is graph.rels[BOUGHT_BY].nbr  # no copy
    assert torch.equal(got.rows, want.rows) and got.rows.dtype == want.rows.dtype
    assert got.max_row == want.max_row and got.num_src == want.num_src


def _capped():
    """One user buys 12 items under rows capped at 8."""
    buys_u = np.array([0] * 12 + [1, 2, 2], dtype=np.int32)
    buys_i = np.array(list(range(12)) + [3, 4, 5], dtype=np.int32)
    return _graph(buys_u, buys_i, 4, 20, max_fanout=8)


def _no_reverse():
    return _graph(np.array([0, 0, 1, 3], np.int32), np.array([2, 5, 2, 1], np.int32), 4, 8,
                  reverse=False)


def _reordered():
    """``bought-by`` holds the same pairs in another edge order."""
    rng = np.random.default_rng(9)
    buys_u = rng.integers(0, 40, size=200).astype(np.int32)
    buys_i = rng.integers(0, 30, size=200).astype(np.int32)
    order = rng.permutation(200)
    return _graph(buys_u, buys_i, 40, 30, reverse=(buys_i[order], buys_u[order]))


def _wider_rows():
    """Rows padded to a multiple of 16: wider than the pack's."""
    buys_u = np.array([0, 0, 1, 2, 2, 2], dtype=np.int32)
    buys_i = np.array([1, 2, 3, 4, 5, 6], dtype=np.int32)
    return _graph(buys_u, buys_i, 3, 8, fanout_multiple=16)


FALLBACKS = {"capped": _capped, "no_reverse": _no_reverse, "reordered": _reordered,
             "wider_rows": _wider_rows}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_bought_table_falls_back_to_the_host_pack(name):
    graph = FALLBACKS[name]()
    want = _packed(graph)
    if name == "reordered":  # the case is real: the graph's rows differ from the pack's
        assert not torch.equal(graph.rels[BOUGHT_BY].nbr, want.rows)
    before = _routes()
    got = bought_table(graph)
    assert _routes() == (before[0], before[1] + 1)
    assert torch.equal(got.rows, want.rows) and got.max_row == want.max_row


def test_traced_serving_wraps_names_the_module_has():
    """The benchmark's traced serving run wraps these by name (``SPANS``): each must stay."""
    assert set(ondemand.SPANS) == {"load_run", "ConvModel", "infer_embeddings",
                                   "build_padded_pair_set", "get_recs"}
    for name in ondemand.SPANS:
        assert callable(getattr(inference, name))


def test_requests_take_the_graph_rows_with_the_same_answers(tmp_path, monkeypatch):
    """A saved run's requests take the graph's rows, one count a request,
    and answer as with the host pack."""
    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.train.checkpoint import save_run

    g = make_synthetic_data(num_users=60, num_items=40, num_groups=4, interactions_per_user=6,
                            test_per_user=1, feat_dim=8, with_clicks=True, seed=5).graph
    dims = (("user", 8), ("item", 8), ("hidden", 16), ("out", 8))
    model = ConvModel(g.canonical_etypes, dims, n_layers=3, aggregator_type="mean_nn",
                      generator=torch.Generator().manual_seed(1))
    run_dir = str(tmp_path / "run")
    save_run(run_dir, model.state_dict(),
             {"canonical_etypes": [list(et) for et in g.canonical_etypes],
              "dims": [list(d) for d in dims], "n_layers": 3, "aggregator_type": "mean_nn"},
             graph=g)
    monkeypatch.setattr(bought_table, "from_graph", 0)
    monkeypatch.setattr(bought_table, "packed", 0)
    monkeypatch.setattr(inference.inference_ondemand, "requests", 0)
    asks = ([0, 7, 59], "all")
    served = [inference.inference_ondemand(run_dir, u, k=5, device="cpu") for u in asks]
    assert _routes() == (inference.inference_ondemand.requests, 0) == (2, 0)
    monkeypatch.setattr(inference, "bought_table", _packed)
    assert [inference.inference_ondemand(run_dir, u, k=5, device="cpu") for u in asks] == served
