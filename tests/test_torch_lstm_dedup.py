"""One minibatch training step of an LSTM model through the dedup'd block
forward, the port against the JAX package (the harness and tolerances of
``tests/test_torch_lstm_steps.py``): each level's unique nodes run the
LSTM once over their sampled mailboxes, padding rows included."""

import pytest
from test_torch_lstm_steps import check_lstm_step
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("agg,fanouts", [("lstm", (3, 2)), ("lstm_edge", (3, -1))])
def test_dedup_step_matches_jax(agg, fanouts):
    check_lstm_step(agg, fanouts, dedup=True)
