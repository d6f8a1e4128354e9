"""The packed leaf cache (``attach_leaf_features`` + ``full_neighbors_packed``)
against the JAX package, and the packed tree against the unpacked one.

The cache holds the same feature rows the per-slot gathers read, so the
cache itself matches exactly and the packed forward equals the unpacked one
bit for bit; against JAX the forward is within 1e-5 (f32 sums in another
order), as in ``test_torch_minibatch.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_minibatch import ET_BUYS, REPR_TOL, _record_draws

from gnn_recsys_tpu.graph.hetero import attach_leaf_features as jattach
from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.sampling import full_neighbors_packed as jpacked
from gnn_recsys_tpu.ops.sampling import exclusion_table as jexclusion_table
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.graph.hetero import attach_leaf_features
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws, full_neighbors_packed
from gnn_recsys_tpu_torch.ops.sampling import exclusion_table
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

DATA_KW = dict(num_users=30, num_items=20, num_groups=3, interactions_per_user=5,
               with_clicks=True, with_sports=True, seed=2)
DIMS = (("user", 8), ("item", 8), ("sport", 8), ("hidden", 16), ("out", 8))


def _graphs():
    jd, td = jmake(**DATA_KW), make_synthetic_data(**DATA_KW)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfeats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    return jd.graph, td.graph, jfeats, tfeats


def test_cache_and_packed_rows_match_jax():
    jg, tg, jfeats, tfeats = _graphs()
    jgp, tgp = jattach(jg, jfeats), attach_leaf_features(tg, tfeats)
    narrow = attach_leaf_features(tg, tfeats, max_width=4)
    ids = np.array([0, 5, 5, 29, 3], dtype=np.int32)
    for et in jg.canonical_etypes:
        np.testing.assert_array_equal(tgp.rels[et].nbr_feat.numpy(),
                                      np.asarray(jgp.rels[et].nbr_feat))
        assert narrow.rels[et].nbr_feat is None  # K = 8 > 4: no cache
        if et[2] != "user":
            continue
        eids = np.arange(4, dtype=np.int32)
        jtable = jexclusion_table(jg.rels[et], jnp.asarray(eids))
        ttable = exclusion_table(tg.rels[et], torch.as_tensor(eids))
        jraw, jmask = jpacked(jgp.rels[et], jnp.asarray(ids), nbr_table=jtable)
        raw, mask = full_neighbors_packed(tgp.rels[et], torch.as_tensor(ids), nbr_table=ttable)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert tgp.to("cpu").rels[ET_BUYS].nbr_feat is not None


@pytest.mark.parametrize("agg,leaf_kernel,fanouts", [
    ("mean", False, (-1, 3)),
    ("mean_nn", True, (-1, 3)),
    ("pool_nn", False, (-1, -1)),
])
def test_packed_tree_matches_jax_and_unpacked(monkeypatch, agg, leaf_kernel, fanouts):
    jg, tg, jfeats, tfeats = _graphs()
    kw = dict(canonical_etypes=jg.canonical_etypes, dims=DIMS, n_layers=3, aggregator_type=agg,
              leaf_kernel=leaf_kernel)
    jm, tm = JConvModel(**kw), ConvModel(**kw)
    params = jfb.init_model(jm, jg, jfeats, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tm.eval()
    seeds = {"user": np.arange(12, dtype=np.int32), "item": np.arange(10, dtype=np.int32)}
    excl = {et: np.arange(3, dtype=np.int32) for et in jg.canonical_etypes}

    uniforms, _ = _record_draws(monkeypatch)
    jout = jm.apply(params, jattach(jg, jfeats), jfeats,
                    {k: jnp.asarray(v) for k, v in seeds.items()}, fanouts,
                    jax.random.PRNGKey(7), exclude_eids={k: jnp.asarray(v) for k, v in excl.items()},
                    method=jm.sampled_repr)

    def run(graph, draws):
        return tm.sampled_repr(graph, tfeats, {k: torch.as_tensor(v) for k, v in seeds.items()},
                               fanouts, draws,
                               exclude_eids={k: torch.as_tensor(v) for k, v in excl.items()})

    draws = ReplayDraws(uniforms)
    packed = run(attach_leaf_features(tg, tfeats), draws)
    assert draws.exhausted
    unpacked = run(tg, ReplayDraws(uniforms))
    for nt in seeds:
        np.testing.assert_allclose(packed[nt].detach().numpy(), np.asarray(jout[nt]),
                                   rtol=0, atol=REPR_TOL)
        if leaf_kernel:  # unpacked: the leaf kernel's einsum, another summation order
            torch.testing.assert_close(packed[nt], unpacked[nt], rtol=0, atol=REPR_TOL)
        else:
            assert torch.equal(packed[nt], unpacked[nt]), nt


def test_packed_tree_skips_the_leaf_kernel_and_keeps_the_draws(monkeypatch):
    """At fanouts (-1, 3) the packed leaf takes no draw, exactly as the
    unpacked full row; with the packed rows the leaf kernel's branch is not
    taken (``conv_model.py:720``)."""
    import gnn_recsys_tpu_torch.models.conv_model as cm

    _, tg, _, tfeats = _graphs()
    tm = ConvModel(tg.canonical_etypes, DIMS, aggregator_type="mean_nn", leaf_kernel=True)
    tm.eval()
    seeds = {"user": torch.arange(6)}
    calls = []
    orig = cm.leaf_mean_nn
    monkeypatch.setattr(cm, "leaf_mean_nn", lambda *a, **k: calls.append(1) or orig(*a, **k))
    draws = Draws(torch.Generator().manual_seed(0), record=True)
    tm.sampled_repr(attach_leaf_features(tg, tfeats), tfeats, seeds, (-1, 3), draws)
    assert not calls
    tm.sampled_repr(tg, tfeats, seeds, (-1, 3), draws.replay())
    assert calls
