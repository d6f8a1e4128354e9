"""The port's message-passing primitives and membership ops against the JAX
package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.graph.hetero import coo_to_padded_csc
from gnn_recsys_tpu.ops import membership as jmem
from gnn_recsys_tpu.ops import message as jmsg
from gnn_recsys_tpu_torch.ops import membership as tmem
from gnn_recsys_tpu_torch.ops import message as tmsg

ATOL = 1e-6


def _inputs(seed=0, n_src=40, n_dst=25, e=200, d=8):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n_src, d)).astype(np.float32)
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = rng.integers(0, n_dst, e).astype(np.int32)
    dst[dst == 3] = 4  # destination 3 has no incoming edge
    w = rng.integers(1, 4, e).astype(np.float32)
    return h, src, dst, w, n_dst


@pytest.mark.parametrize("name", ["coo_segment_mean", "coo_segment_max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_coo_segment_matches_jax(name, weighted):
    h, src, dst, w, n_dst = _inputs()
    jw = jnp.asarray(w) if weighted else None
    tw = torch.from_numpy(w) if weighted else None
    ref = getattr(jmsg, name)(jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst), n_dst, jw)
    out = getattr(tmsg, name)(torch.from_numpy(h), torch.from_numpy(src),
                              torch.from_numpy(dst), n_dst, tw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert (out[3] == 0).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_csc_gather_mean_matches_jax(weighted):
    h, src, dst, w, n_dst = _inputs(seed=1)
    nbr, nbr_eid, nbr_mask, _ = coo_to_padded_csc(src, dst, n_dst)
    nbr = np.where(nbr_mask, nbr, -1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (h, nbr, nbr_mask, nbr_eid)]
    targs = [torch.from_numpy(a) for a in (h, nbr, nbr_mask, nbr_eid)]
    ref = jmsg.csc_gather_mean(*jargs, jnp.asarray(w) if weighted else None)
    out = tmsg.csc_gather_mean(*targs, torch.from_numpy(w) if weighted else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_edge_dot_matches_jax():
    rng = np.random.default_rng(2)
    hu = rng.normal(size=(20, 16)).astype(np.float32)
    hv = rng.normal(size=(30, 16)).astype(np.float32)
    s = rng.integers(0, 20, 50).astype(np.int32)
    d = rng.integers(0, 30, 50).astype(np.int32)
    ref = jmsg.edge_dot(*(jnp.asarray(a) for a in (hu, hv, s, d)))
    out = tmsg.edge_dot(*(torch.from_numpy(a) for a in (hu, hv, s, d)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_pair_set_contains_and_row_mask_match_jax():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 15, 120).astype(np.int32)
    i = rng.integers(0, 40, 120).astype(np.int32)
    jp, tp = jmem.build_padded_pair_set(u, i, 15), tmem.build_padded_pair_set(u, i, 15)
    qu = rng.integers(0, 15, 30).astype(np.int32)
    qv = rng.integers(-1, 40, (30, 7)).astype(np.int32)  # -1 probes never match
    ref = jmem.pair_set_contains(jp, jnp.asarray(qu), jnp.asarray(qv))
    out = tmem.pair_set_contains(tp, torch.from_numpy(qu), torch.from_numpy(qv))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref1 = jmem.pair_set_contains(jp, jnp.asarray(qu), jnp.asarray(qv[:, 0]))
    out1 = tmem.pair_set_contains(tp, torch.from_numpy(qu), torch.from_numpy(qv[:, 0]))
    np.testing.assert_array_equal(out1.numpy(), np.asarray(ref1))
    np.testing.assert_array_equal(
        tmem.scatter_row_mask(tp, torch.from_numpy(qu), 40).numpy(),
        np.asarray(jmem.scatter_row_mask(jp, jnp.asarray(qu), 40)),
    )
