"""One training step of every negative mode and loss against the JAX
package, through the device epochs' body (``train/minibatch.py:make_epoch_fns``,
the body a CUDA graph captures on the card): JAX's default ``shared_pool``
(here without batch-edge exclusion; with it, and ``dense_pool``, in
``tests/test_torch_device_epoch.py``), ``per_edge``, ``sampled_softmax`` and
the recency weights, each from the same parameters, permutation and draws,
at the tolerances of ``tests/test_torch_minibatch.py``."""

import pytest
from test_torch_device_epoch import check_epoch_body_against_jax, epoch_cfg
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "shared_pool": (epoch_cfg("shared_pool"), False),
    "per_edge": (epoch_cfg("per_edge"), True),
    "sampled_softmax": (epoch_cfg("shared_pool", loss="sampled_softmax"), True),
    "use_recency": (epoch_cfg("shared_pool", use_recency=True), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_negative_mode_and_loss_matches_jax(monkeypatch, case):
    cfg_kw, with_exclusion = CASES[case]
    check_epoch_body_against_jax(monkeypatch, cfg_kw, with_exclusion)
