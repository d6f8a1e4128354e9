"""``train_full_batch`` with the LSTM aggregator, the port against the JAX
package from the same parameters and negatives (the harness and tolerances
of ``tests/test_torch_full_batch.py``: losses within ``LOSS_RTOL``)."""

import jax
import numpy as np
from test_torch_full_batch import DATA_KW, NEG, _pair, jax_negatives
from test_torch_minibatch import LOSS_RTOL, one_torch_thread  # noqa: F401 (autouse)

from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.train import full_batch as tfb


def test_train_full_batch_lstm_matches_jax():
    """Two epochs of ``train_full_batch`` with the LSTM, from JAX's
    parameters and negatives: the losses and the metrics agree."""
    cfg = dict(neg_sample_size=NEG, lr=3e-3, num_epochs=2, eval_every=1, k=5, seed=2)
    jd, td, jm, tm, jfeats, tfeats, _ = _pair("cos", agg="lstm", seed=cfg["seed"])
    etypes = tuple(jd.train_pairs)
    negs, rng = [], jax.random.PRNGKey(cfg["seed"])
    for _ in range(cfg["num_epochs"]):
        rng, sub = jax.random.split(rng)
        negs += jax_negatives(sub, [jd.train_pairs[et][0] for et in etypes],
                              DATA_KW["num_items"], NEG)
    bought = jd.train_pairs[("user", "buys", "item")]
    _, jhist = jfb.train_full_batch(jm, jd.graph, jd.graph, jfeats, jd.train_pairs,
                                    jd.test_ground_truth, jfb.FullBatchConfig(**cfg),
                                    already_bought=bought)
    draws = ReplayDraws([], negs)
    state, thist = tfb.train_full_batch(tm, td.graph, td.graph, tfeats, td.train_pairs,
                                        td.test_ground_truth, tfb.FullBatchConfig(**cfg),
                                        already_bought=bought,
                                        state=tfb.TrainState.create(tm, lr=cfg["lr"]),
                                        draws=draws, device="cpu")
    assert draws.exhausted and state.step == 2
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=LOSS_RTOL)
    for name in ("recall", "precision", "coverage"):
        np.testing.assert_allclose(thist[name], jhist[name], rtol=1e-6, err_msg=name)
