"""The gather-mean kernel's plain versions against the JAX package's
``gather_mean_pallas`` (interpret mode) and ``csc_gather_mean``, its gradient
against ``jax.grad``, and ``unique_capped`` against ``jnp.unique``.

Tolerances: rtol 1e-5 / atol 1e-6 for the forward (sums of K terms in another
order, then one division); the same for the gradient through ``autograd``.
The backward's plain version (the walk over a transpose) against
``index_add_`` and ``jax.grad``: rtol and atol 1e-6, since each entry of dh
is a sum of a few scaled cotangent rows, added in another order than XLA's
scatter.  ``jax.grad`` cannot differentiate ``gather_mean_pallas`` (a
``pallas_call`` has no transpose rule), so gradients are held against
``jax.grad`` of ``csc_gather_mean``, the same contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.ops.message import csc_gather_mean as jcsc_gather_mean
from gnn_recsys_tpu.ops.pallas.gather_mean import gather_mean_pallas
from gnn_recsys_tpu_torch.ops import message as tmsg
from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
from gnn_recsys_tpu_torch.ops.sampling import unique_capped, unique_plan

RTOL, ATOL = 1e-5, 1e-6
BWD_TOL = 1e-6


def _case(b, k, n, d, seed=0):
    """The shapes of tests/test_pallas_gather.py plus a zero-degree row, ids
    of -1 and ids >= n (both clipped into range)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    nbr = rng.integers(0, n, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.7
    mask[0] = False  # a zero-degree row
    nbr[1, 0], nbr[2, 1] = -1, n + 5
    mask[1, 0] = mask[2, 1] = True  # valid slots whose ids get clipped
    nbr[3, :] = -1  # padding where masked
    mask[3, 1:] = False
    return h, nbr, mask


@pytest.mark.parametrize("b,k,n,d", [(13, 8, 50, 16), (32, 16, 200, 32)])
def test_forward_matches_pallas_and_csc_gather_mean(b, k, n, d):
    h, nbr, mask = _case(b, k, n, d)
    pallas = np.asarray(gather_mean_pallas(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask),
                                           tile_rows=4, interpret=True))
    xla = np.asarray(jcsc_gather_mean(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask)))
    th, tn, tm = torch.tensor(h), torch.tensor(nbr), torch.tensor(mask)
    for out in (gm.gather_mean(th, tn, tm), gm.gather_mean_fwd(th, tn.long(), tm),
                tmsg.csc_gather_mean(th, tn, tm)):
        np.testing.assert_allclose(out.numpy(), pallas, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), xla, rtol=RTOL, atol=ATOL)
        assert (out[0] == 0).all()


@pytest.mark.parametrize("b,k,n,d", [(13, 8, 50, 16), (32, 16, 200, 32)])
def test_gradient_matches_jax_grad(b, k, n, d):
    h, nbr, mask = _case(b, k, n, d, seed=1)
    c = np.random.default_rng(2).normal(size=(b, d)).astype(np.float32)

    def jloss(h_):
        return jnp.sum(jcsc_gather_mean(h_, jnp.asarray(nbr), jnp.asarray(mask)) * c)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(h)))
    th = torch.tensor(h, requires_grad=True)
    (gm.gather_mean(th, torch.tensor(nbr), torch.tensor(mask)) * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    # The plain backward (the backward kernel's oracle) gives the same.
    dh = gm.gather_mean_bwd(torch.tensor(c), torch.tensor(nbr), torch.tensor(mask), n)
    np.testing.assert_allclose(dh.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,k,n,d", [(13, 8, 50, 16), (32, 16, 200, 32), (7, 40, 20, 33),
                                     (6, 4, 1, 8), (9, 1, 30, 4)])
def test_transpose_backward_matches_index_add_and_jax_grad(b, k, n, d):
    """The plain backward over the wrapper's own transpose (masked rows, ids
    of -1 and >= N, K > 32, N = 1, K = 1)."""
    h, nbr, mask = _case(b, k, n, d, seed=3) if k > 1 else _case(b, 2, n, d, seed=3)
    nbr, mask = nbr[:, :k], mask[:, :k]
    c = np.random.default_rng(4).normal(size=(b, d)).astype(np.float32)
    want = np.asarray(jax.grad(lambda h_: jnp.sum(jcsc_gather_mean(
        h_, jnp.asarray(nbr), jnp.asarray(mask)) * c))(jnp.asarray(h)))
    tn, tm, tc = torch.tensor(nbr), torch.tensor(mask), torch.tensor(c)
    tr = gm.slot_transpose(tn, tm, n)
    dh = gm.gather_mean_bwd_plain(tc, tm, n, tr)
    np.testing.assert_allclose(dh.numpy(), want, rtol=BWD_TOL, atol=BWD_TOL)
    ref = gm.gather_mean_bwd_reference(tc, tn, tm, n)
    np.testing.assert_allclose(dh.numpy(), ref.numpy(), rtol=BWD_TOL, atol=BWD_TOL)
    assert torch.equal(gm.gather_mean_bwd(tc, tn, tm, n), dh)  # the wrapper builds the same


def test_slot_transpose_groups_each_rows_valid_slots():
    h, nbr, mask = _case(13, 8, 50, 16)
    n = h.shape[0]
    tr = gm.slot_transpose(torch.tensor(nbr), torch.tensor(mask), n)
    order, start = tr.order.numpy(), tr.start.numpy()
    assert tr.order.dtype == tr.start.dtype == torch.int32 and start.shape == (n + 1,)
    flat_ids, flat_mask = np.clip(nbr, 0, n - 1).reshape(-1), mask.reshape(-1)
    for u in range(n):
        want = np.nonzero(flat_mask & (flat_ids == u))[0]  # ascending slots
        np.testing.assert_array_equal(order[start[u]:start[u + 1]], want)
    # Masked slots sort past every row and are never walked.
    assert start[n] == flat_mask.sum() and not flat_mask[order[start[n]:]].any()


def test_backward_walks_only_its_segment_up_to_rows():
    """A plan-like transpose: one sort of a frontier that holds two gathers'
    slots; the second gather (entries from ``off``) walks its own rows below
    ``rows`` only.  Its padding rows point at one hot row and carry a zero
    cotangent, so ``index_add_`` over every slot gives the same bits."""
    rng = np.random.default_rng(5)
    n, b, k, d, rows = 30, 20, 4, 8, 15
    other = rng.integers(0, n, 50).astype(np.int32)
    nbr = rng.integers(0, n, (b, k)).astype(np.int32)
    nbr[rows:] = 7  # padding rows: a hot row
    mask = rng.random((b, k)) < 0.8
    plan = unique_plan(torch.tensor(np.concatenate([other, nbr.reshape(-1)])), 40,
                       transpose=True)
    off = other.size
    pos = plan.inv[off:].reshape(b, k)
    c = rng.normal(size=(b, d)).astype(np.float32)
    c[rows:] = 0.0
    tr = gm.SlotTranspose(plan.order, plan.start, off, torch.tensor([rows], dtype=torch.int32))
    dh = gm.gather_mean_bwd(torch.tensor(c), pos, torch.tensor(mask), 40, tr)
    tc, tm = torch.tensor(c), torch.tensor(mask)
    assert torch.equal(dh, gm.gather_mean_bwd_reference(tc, pos, tm, 40))
    assert torch.equal(dh, gm.gather_mean_bwd(tc, pos, tm, 40))  # the wrapper's own transpose


@pytest.mark.parametrize("n,high,cap", [(40, 10, 16), (37, 1000, 40), (64, 64, 64), (5, 3, 8)])
def test_unique_plan_transpose_lists_each_positions_slots(n, high, cap):
    flat = np.random.default_rng(n).integers(0, high, n).astype(np.int32)
    plan = unique_plan(torch.tensor(flat), cap, transpose=True)
    inv, order, start = plan.inv.numpy(), plan.order.numpy(), plan.start.numpy()
    distinct = len(np.unique(flat))
    assert plan.count.dtype == torch.int32 and plan.count.tolist() == [distinct]
    assert start.shape == (cap + 1,) and (start[distinct:] == n).all()
    for u in range(cap):
        np.testing.assert_array_equal(order[start[u]:start[u + 1]], np.nonzero(inv == u)[0])


@pytest.mark.parametrize("n,high,cap", [(40, 10, 16), (37, 1000, 40), (64, 64, 64), (5, 3, 8)])
def test_unique_capped_matches_jnp_unique(n, high, cap):
    """Capacities at and above the number of distinct ids (padding with 0)."""
    flat = np.random.default_rng(n).integers(0, high, n).astype(np.int32)
    ju, jinv = jnp.unique(jnp.asarray(flat), return_inverse=True, size=cap, fill_value=0)
    tu, tinv = unique_capped(torch.tensor(flat), cap)
    assert tu.dtype == torch.int32 and tinv.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv).reshape(-1))
    np.testing.assert_array_equal(tu.numpy()[tinv.numpy()], flat)


def test_cpu_tensors_take_the_plain_route():
    h, nbr, mask = _case(9, 4, 20, 8)
    counts = (gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches)
    th = torch.tensor(h, requires_grad=True)
    out = gm.gather_mean(th, torch.tensor(nbr), torch.tensor(mask))
    out.sum().backward()
    gm.gather_mean_fwd(torch.tensor(h), torch.tensor(nbr), torch.tensor(mask))
    gm.gather_mean_bwd(out.detach(), torch.tensor(nbr), torch.tensor(mask), 20)
    assert (gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches) == counts
    torch.testing.assert_close(out, gm.gather_mean_reference(torch.tensor(h), torch.tensor(nbr),
                                                             torch.tensor(mask)))


def test_wide_k_hub_row_matches_jax():
    """K = 300 with a hub row (row 11 read by a third of the slots, about
    2,000 of them): the port's plain forward against ``csc_gather_mean`` and
    its gradient through ``gather_mean`` against ``jax.vjp``.  The hub's
    gradient sums about 2,000 scaled rows in another order than XLA's
    scatter, so the gradient takes rtol / atol 1e-5."""
    b, k, n, d = 24, 300, 40, 8
    h, nbr, mask = _case(b, k, n, d, seed=4)
    nbr[4:, ::3] = 11
    c = np.random.default_rng(5).normal(size=(b, d)).astype(np.float32)
    xla, vjp = jax.vjp(lambda h_: jcsc_gather_mean(h_, jnp.asarray(nbr), jnp.asarray(mask)),
                       jnp.asarray(h))
    (want,) = vjp(jnp.asarray(c))
    th = torch.tensor(h, requires_grad=True)
    out = gm.gather_mean(th, torch.tensor(nbr), torch.tensor(mask))
    out.backward(torch.tensor(c))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(xla), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert int((torch.tensor(nbr)[torch.tensor(mask)] == 11).sum()) > 10 * gm.CHUNK
    dh = gm.gather_mean_bwd_plain(torch.tensor(c), torch.tensor(mask), n,
                                  gm.slot_transpose(torch.tensor(nbr), torch.tensor(mask), n))
    np.testing.assert_allclose(dh.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _plan_transpose(rng, n, b, k, ids, rows):
    """A plan's transpose of ``ids`` [b, k] inside one sort of a frontier
    with other slots before and after (``unique_plan``), walked up to
    ``rows``."""
    before, after = rng.integers(0, n, 500), rng.integers(0, n, 700)
    flat = torch.tensor(np.concatenate([before, ids.reshape(-1), after]).astype(np.int32))
    plan = unique_plan(flat, n, transpose=True)
    rows_t = None if rows is None else torch.tensor([rows], dtype=torch.int32)
    return gm.SlotTranspose(plan.order, plan.start, before.size, rows_t)


@pytest.mark.parametrize("case", ["uniform", "hub", "every_run_one_past_a_chunk", "no_rows"])
def test_chunk_plan_covers_each_walked_entry_once(case):
    """The backward's cut of the runs at K other than 4 and 8: every entry
    whose slot lies in [off, off + rows * K) falls in exactly one chunk, no
    other entry in any; each chunk holds at most CHUNK entries, all but a
    row's last exactly CHUNK; every row has a chunk (an empty run writes its
    zeros); and the slots used stay within ``chunk_slots``, which sizes the
    scratch, even where every run is one entry longer than a chunk."""
    rng = np.random.default_rng(7)
    b, k, n, rows = 40, 300, 50, 31
    ids = rng.integers(0, n, (b, k))
    if case == "hub":
        ids[:, ::2] = 7  # a run of 6,000 entries
    elif case == "every_run_one_past_a_chunk":  # the rest on one more row
        full = b * k // (gm.CHUNK + 1)
        ids = np.full(b * k, full)
        ids[:full * (gm.CHUNK + 1)] = np.repeat(np.arange(full), gm.CHUNK + 1)
        ids, n, rows = ids.reshape(b, k), full + 1, b
    tr = _plan_transpose(rng, n, b, k, ids, None if case == "no_rows" else rows)
    lo, hi, cstart = gm.chunk_plan(tr, n, b, k)
    limit = b if tr.rows is None else rows
    assert int(cstart[n]) <= gm.chunk_slots(b, k, n)
    covered = torch.zeros(tr.order.numel(), dtype=torch.int64)
    for u in range(n):
        nch = int(cstart[u + 1] - cstart[u])
        assert nch >= 1 and tr.start[u] <= lo[u] <= hi[u] <= tr.start[u + 1]
        for c in range(nch):
            a, e = int(lo[u]) + c * gm.CHUNK, min(int(lo[u]) + (c + 1) * gm.CHUNK, int(hi[u]))
            assert e - a == gm.CHUNK or c == nch - 1
            assert a < e or nch == 1
            covered[a:e] += 1
    p = tr.order.long() - tr.off
    assert torch.equal(covered, ((p >= 0) & (p < limit * k)).long())
    if case == "every_run_one_past_a_chunk":
        assert int(cstart[n]) > 1.9 * n  # two chunks a row, near the bound


@pytest.mark.parametrize("n,b,k,d", [(3000, 904, 1280, 256), (6000, 20000, 16, 2), (7, 5, 3, 6),
                                     (30000, 38912, 8, 256), (1, 9, 4, 256)])
def test_bwd_scratch_bytes_holds_the_plan(n, b, k, d):
    """The scratch of the any-K backward: none at K = 4 and 8; else a scale
    a destination row, three ints a table row and one more, a flag a chunk
    slot, then a 16-byte aligned f32 partial row a chunk slot."""
    nbytes = gm.bwd_scratch_bytes(n, b, k, d)
    if k in (4, 8):
        assert nbytes == 0
        return
    slots = gm.chunk_slots(b, k, n)
    assert slots == n + -(-b * k // gm.CHUNK)
    partial = nbytes - 4 * slots * d
    assert partial % 16 == 0 and 0 <= partial - 4 * (b + 3 * n + 1 + slots) < 16
