"""Exact resume of the port's host training loop (the port of
``tests/test_minibatch.py:235-290``): 4 straight epochs equal 2 epochs, then
``save_train_state`` / ``load_train_state``, then 2 more, because every
epoch's draws and batch order are a function of (seed, epoch)."""

import numpy as np
import pytest
import torch

from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.train.checkpoint import load_train_state, save_train_state
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.train.minibatch import MinibatchConfig, train_minibatch
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

ET_BUYS = ("user", "buys", "item")
ET_CLICKS = ("user", "clicks", "item")


def _world():
    data = make_synthetic_data(num_users=30, num_items=20, num_groups=4,
                               interactions_per_user=6, test_per_user=2, feat_dim=8,
                               with_clicks=True, seed=0)
    return data.graph, {nt: data.graph.ndata[nt]["features"] for nt in data.graph.ntypes}


def _model(g, agg):
    return ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 32), ("out", 16)),
                     n_layers=3, aggregator_type=agg)


@pytest.mark.parametrize("agg,dedup", [("mean", False), ("mean_nn", True)])
def test_resume_from_checkpoint_is_exact(tmp_path, agg, dedup):
    g, feats = _world()
    train_eids = {et: np.arange(g.num_edges(et)) for et in (ET_BUYS, ET_CLICKS)}

    def cfg(num_epochs):
        return MinibatchConfig(edge_batch_size=96, fanouts=(4, 4), neg_sample_size=5,
                               neg_mode="shared_pool", neg_pool_size=32, lr=3e-3,
                               num_epochs=num_epochs, metrics_every=0, patience=100, seed=3,
                               dedup=dedup)

    def train(num_epochs, **kw):
        model = kw.pop("model", None) or _model(g, agg)
        return train_minibatch(model, g, g, feats, train_eids, None, cfg(num_epochs),
                               device="cpu", **kw)[0]

    straight = train(4)
    first = train(2)
    path = str(tmp_path / "state.pt")
    save_train_state(first, path)
    model = _model(g, agg)  # other weights until the state is loaded
    restored = load_train_state(path, TrainState.create(model, lr=3e-3))
    assert restored.step == first.step > 0
    resumed = train(4, model=model, state=restored, start_epoch=2)
    assert resumed.step == straight.step
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_state_round_trip_keeps_the_schedule(tmp_path):
    """Adam's moments, the cosine schedule and the step count survive a save
    and a load into a fresh state."""
    g, _ = _world()
    model = _model(g, "mean_nn")
    state = TrainState.create(model, lr=3e-3, decay_steps=10)
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        state.apply_gradients()
    path = str(tmp_path / "state.pt")
    save_train_state(state, path)
    other = _model(g, "mean_nn")
    restored = load_train_state(path, TrainState.create(other, lr=3e-3, decay_steps=10))
    assert restored.step == 3
    assert restored.tx.param_groups[0]["lr"] == state.tx.param_groups[0]["lr"]
    assert restored.schedule.last_epoch == state.schedule.last_epoch
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
        sa, sb = state.tx.state[a], restored.tx.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    with pytest.raises(ValueError):
        load_train_state(path, TrainState.create(_model(g, "mean_nn"), lr=3e-3))
