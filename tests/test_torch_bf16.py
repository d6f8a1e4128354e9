"""bf16 compute: the port's ``ConvModel(dtype=torch.bfloat16)`` against the
JAX package's ``ConvModel(dtype=jnp.bfloat16)``, with JAX's parameters
carried over by ``params_from_jax`` and JAX's draws replayed.

The JAX reference is JAX's bf16 program compiled with XLA's excess precision
off (``xla_allow_excess_precision=False``): every op then rounds its result
to bf16 as the program is written, as when JAX runs it op by op.  By default
XLA on the CPU keeps f32 inside a fused chain of bf16 elementwise ops, which
moves a quarter of these outputs by a bf16 ulp; the port rounds after each
op, as JAX's program states.  Draws are recorded inside the compiled program
(``jax.debug.callback``, in program order).

Tolerances, each with its reason:

* forwards and embeddings: with ``e = max |port - jax_bf16|`` and ``g = max
  |jax_f32 - jax_bf16|`` on the same parameters and inputs, ``e <= E_OVER_G
  * g``: the port rounds to bf16 where JAX does, not just close to the f32
  result.  Measured on these inputs: e = 0 against g = 0.0168 (tree, leaf
  kernel), 0.0286 (tree), 0.0174 (dedup) and 0.0323 (``pool_nn_edge``
  embeddings); e = 2**-8 against g = 0.0777 for the ``mean_nn`` embeddings
  (one f32 segment sum taken in another order rounds the other way), held
  against JAX with its full-graph mean summing in f32 as the port's does:
  JAX as it is sums in bf16 and gives e = 0.0693 against g = 0.0718;
* the loss of a bf16 step within ``LOSS_RTOL`` relative (scores leave the
  model as f32; the loss is f32);
* each parameter's gradient within ``GRAD_REL`` of its largest entry: the
  backward runs in bf16 (a bf16 Linear's weight gradient is a bf16 product,
  widened by the cast's backward), in another order than JAX's transposes;
* ``gather_mean`` forward against ``gather_mean_pallas``: ``GATHER_RTOL``
  (one bf16 ulp) element by element, since both round the same f32 sums of
  K terms taken in another order; the backward against ``jax.vjp``: two ulps
  of the largest entry (``GATHER_BWD_REL``), since JAX adds each slot's
  cotangent into dh in bf16 and the port sums in f32 and rounds once;
* ``coo_segment_mean`` at in-degrees up to 16 within ``COO_ATOL`` of JAX's
  (JAX adds the messages one at a time in bf16, a few ulps at that degree),
  and within ``GATHER_RTOL`` of the exact mean (the port rounds once);
* recommendations from bf16 embeddings: the port ranks the embeddings
  widened to f32, JAX by bf16 scores, so lists may differ at near-ties:
  their scores within ``RECS_SCORE_ATOL``.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minibatch import (
    DATA_KW,
    ET_BUYS,
    _batch,
    one_torch_thread,  # noqa: F401 (autouse)
)

import gnn_recsys_tpu.models.conv_model as jcm
from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops import message as jmsg
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.ops.pallas.gather_mean import gather_mean_pallas
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops import message as tmsg
from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.train.full_batch import compute_embeddings
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

E_OVER_G = 0.5
LOSS_RTOL = 1e-2
GRAD_REL = 5e-2
GATHER_RTOL = 2.0**-7
GATHER_BWD_REL = 2 * 2.0**-7
COO_ATOL = 2.0**-6
RECS_SCORE_ATOL = 2.0**-7
NO_EXCESS = {"xla_allow_excess_precision": False}
DIMS = (("user", 8), ("item", 8), ("hidden", 16), ("out", 8))
REVERSE_BUYS = ("item", "bought-by", "user")


def _compiled(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _recording():
    """(uniforms, randints, patch): while ``patch`` is active, every
    ``jax.random.uniform`` / ``randint`` result, also inside a compiled
    program, is appended to its list in program order."""
    uniforms, randints = [], []

    def recorder(orig, into):
        def draw(*a, **k):
            out = orig(*a, **k)
            jax.debug.callback(lambda v: into.append(np.array(v)), out, ordered=True)
            return out
        return draw

    patch = unittest.mock.patch.multiple(
        jax.random, uniform=recorder(jax.random.uniform, uniforms),
        randint=recorder(jax.random.randint, randints))
    return uniforms, randints, patch


def _pair(agg="mean_nn", leaf_kernel=False, hetero="sum", data_kw=DATA_KW):
    """The same graph and parameters in both packages: the JAX models in f32
    and bf16, and the port's in bf16."""
    jd, td = jmake(**data_kw), make_synthetic_data(**data_kw)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=3,
              aggregator_type=agg, aggregator_hetero=hetero, leaf_kernel=leaf_kernel)
    j32, j16 = JConvModel(**kw), JConvModel(**kw, dtype=jnp.bfloat16)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfeats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    params = jfb.init_model(j32, jd.graph, jfeats, seed=0)
    tm = ConvModel(**kw, dtype=torch.bfloat16)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jd, td, j32, j16, tm, jfeats, tfeats, params


def _e_and_g(port, jax_bf16, jax_f32):
    """(e, g) of the module docstring over the node types of ``port``."""
    e = max(float(np.abs(port[nt].detach().float().numpy()
                         - np.asarray(jax_bf16[nt], np.float32)).max()) for nt in port)
    g = max(float(np.abs(np.asarray(jax_f32[nt], np.float32)
                         - np.asarray(jax_bf16[nt], np.float32)).max()) for nt in port)
    return e, g


@pytest.mark.parametrize("leaf_kernel,dedup", [(True, False), (False, False), (False, True)],
                         ids=["tree-leaf-kernel", "tree", "dedup"])
def test_sampled_forward_matches_jax_bf16(leaf_kernel, dedup):
    """The tree forward (the Pallas leaf in interpret mode, or the composed
    leaf) and the dedup'd block forward (JAX's plain means against the
    gather-mean's plain version): bf16 out, rounded where JAX rounds."""
    jd, td, j32, j16, tm, jfeats, tfeats, params = _pair(leaf_kernel=leaf_kernel)
    seeds = {"user": np.arange(12, dtype=np.int32),
             "item": np.arange(10, dtype=np.int32).reshape(5, 2)}
    excl = {ET_BUYS: np.arange(6, dtype=np.int32), REVERSE_BUYS: np.arange(6, dtype=np.int32)}

    def forward(model):
        return lambda p: model.apply(
            p, jd.graph, jfeats, {k: jnp.asarray(v) for k, v in seeds.items()}, (4, 3),
            jax.random.PRNGKey(7), exclude_eids={k: jnp.asarray(v) for k, v in excl.items()},
            dedup=dedup, method=model.sampled_repr)

    uniforms, _, patch = _recording()
    with patch:
        jout = _compiled(forward(j16), params)
        jax.effects_barrier()
    jref = jax.jit(forward(j32))(params)
    tm.eval()
    draws = ReplayDraws(uniforms)
    tout = tm.sampled_repr(td.graph, tfeats, {k: torch.as_tensor(v) for k, v in seeds.items()},
                           (4, 3), draws, dedup=dedup,
                           exclude_eids={k: torch.as_tensor(v) for k, v in excl.items()})
    assert draws.exhausted
    for nt in seeds:
        assert tout[nt].dtype == torch.bfloat16 and tuple(tout[nt].shape) == jout[nt].shape
    e, g = _e_and_g(tout, jout, jref)
    assert g > 0 and e <= E_OVER_G * g, (e, g)


@pytest.mark.parametrize("leaf_kernel,dedup", [(True, False), (False, True)],
                         ids=["tree-leaf-kernel", "dedup"])
def test_step_matches_jax_bf16(leaf_kernel, dedup):
    """One dense-pool step (batch-edge exclusion, false-negative mask,
    max-margin loss) from the same parameters, pool and draws: the loss and
    each parameter's gradient.  The parameters and their gradients are f32
    on both sides."""
    jd, td, _, j16, tm, jfeats, tfeats, params = _pair(leaf_kernel=leaf_kernel)
    etypes = tuple(jd.train_pairs)
    has_reverse = {et: True for et in etypes}
    cfg_kw = dict(edge_batch_size=32, fanouts=(3, 3), neg_mode="dense_pool",
                  neg_pool_size=24, neg_sample_size=24, dedup=dedup)
    jbatch, tbatch = _batch(jd.train_pairs)
    jtables = {et: jbuild_pairs(u, i, num_src=40) for et, (u, i) in jd.train_pairs.items()}
    ttables = {et: build_padded_pair_set(u, i, num_src=40)
               for et, (u, i) in td.train_pairs.items()}

    def grads_as_params(self, *, grads, **kw):  # the step returns the gradients
        return self.replace(params=grads)

    uniforms, randints, patch = _recording()
    with patch, unittest.mock.patch.object(jfb.TrainState, "apply_gradients", grads_as_params):
        jstep = jmb.make_minibatch_step(j16, jmb.MinibatchConfig(**cfg_kw), etypes,
                                        with_update=True, with_exclusion=True,
                                        has_reverse=has_reverse, jit=False)
        jstate = jfb.TrainState.create(apply_fn=j16.apply, params=params, tx=optax.adam(1e-3))
        jgrads, jloss = _compiled(jstep, jstate, jd.graph, jfeats, jbatch, jtables,
                                  jax.random.PRNGKey(5))
        jax.effects_barrier()

    state = tmb.TrainState.create(tm, lr=1e-3)
    tstep = tmb.make_minibatch_step(tm, tmb.MinibatchConfig(**cfg_kw), etypes, with_update=True,
                                    with_exclusion=True, has_reverse=has_reverse)
    draws = ReplayDraws(uniforms, randints)
    state, tloss = tstep(state, td.graph, tfeats, tbatch, ttables, draws)
    assert draws.exhausted and tloss.dtype == torch.float32
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads.params))
    for name, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        scale = max(float(want[name].abs().max()), 1e-30)
        assert float((p.grad - want[name]).abs().max()) <= GRAD_REL * scale, name


def _f32_segment_mean(h_src, src, dst, num_dst, edge_weight=None):
    """JAX's ``coo_segment_mean`` with the port's accumulation: messages and
    count summed in f32, the mean rounded to the table's dtype once."""
    msgs = jnp.take(h_src, src, axis=0)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    total = jax.ops.segment_sum(msgs.astype(jnp.float32), dst, num_segments=num_dst)
    count = jax.ops.segment_sum(jnp.ones(src.shape[0], jnp.float32), dst, num_segments=num_dst)
    return (total / jnp.maximum(count, 1.0)[:, None]).astype(h_src.dtype)


@pytest.mark.parametrize("agg,hetero,full_graph_mean",
                         [("mean_nn", "sum", True), ("pool_nn_edge", "max", False)])
def test_compute_embeddings_match_jax_bf16(monkeypatch, agg, hetero, full_graph_mean):
    """The full-graph pass gives bf16 embeddings, as JAX's does, held first
    against JAX as it is.  The ``pool_nn_edge`` pass takes no full-graph
    mean and matches it (e = 0 against g = 0.0323).  The ``mean_nn`` pass
    goes through JAX's ``coo_segment_mean``, which sums in bf16
    (``test_coo_segment_mean_bf16_sums_in_f32``): against it, e = 0.0693 and
    g = 0.0718, beyond ``E_OVER_G`` even at these in-degrees (at most about
    30), and the test asserts that it is.  So the ``mean_nn`` reference is
    then JAX with a ``coo_segment_mean`` that sums in f32 as the port does,
    the rest JAX's: e = 2**-8 against g = 0.0777."""
    data_kw = dict(num_users=50, num_items=30, seed=0)
    jd, td, j32, j16, tm, jfeats, tfeats, params = _pair(agg, hetero=hetero, data_kw=data_kw)

    def embeddings(model):
        return lambda p: model.apply(
            p, method=lambda m: m.get_repr(jd.graph, m.embed_features(jfeats),
                                           deterministic=True))

    jref = jax.jit(embeddings(j32))(params)
    out = compute_embeddings(tm, td.graph, tfeats, device="cpu")
    jout = _compiled(embeddings(j16), params)
    assert sorted(out) == sorted(jout)
    assert all(x.dtype == torch.bfloat16 for x in out.values())
    e, g = _e_and_g(out, jout, jref)
    if full_graph_mean:
        assert e > E_OVER_G * g, (e, g)  # JAX's bf16 sums: the reason for the f32 reference
        monkeypatch.setattr(jcm, "coo_segment_mean", _f32_segment_mean)
        e, g = _e_and_g(out, _compiled(embeddings(j16), params), jref)
    assert g > 0 and e <= E_OVER_G * g, (e, g)


def test_gather_mean_bf16_matches_pallas_and_vjp():
    """The gather-mean's plain versions in bf16 (what the CPU runs) against
    ``gather_mean_pallas`` in bf16 (interpret mode) and ``jax.vjp`` of
    ``csc_gather_mean`` (the same contract: a ``pallas_call`` has no
    transpose); a zero-degree row and ids of -1 and >= N."""
    rng = np.random.default_rng(0)
    b, k, n, d = 13, 8, 50, 16
    h = rng.normal(size=(n, d)).astype(np.float32)
    nbr = rng.integers(0, n, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.7
    mask[0] = False
    nbr[1, 0], nbr[2, 1] = -1, n + 5
    mask[1, 0] = mask[2, 1] = True
    g = rng.normal(size=(b, d)).astype(np.float32)
    hb, gb = jnp.asarray(h, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    jn, jm = jnp.asarray(nbr), jnp.asarray(mask)
    pallas = gather_mean_pallas.lower(hb, jn, jm, tile_rows=4, interpret=True).compile(
        compiler_options=NO_EXCESS)(hb, jn, jm)
    jdh = _compiled(lambda hh, gg: jax.vjp(lambda x: jmsg.csc_gather_mean(x, jn, jm), hh)[1](gg)[0],
                    hb, gb)

    th = torch.tensor(h).bfloat16().requires_grad_()
    out = gm.gather_mean(th, torch.tensor(nbr), torch.tensor(mask))
    out.backward(torch.tensor(g).bfloat16())
    assert out.dtype == th.grad.dtype == torch.bfloat16 and (out[0] == 0).all()
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(pallas, np.float32),
                               rtol=GATHER_RTOL, atol=0)
    want = np.asarray(jdh, np.float32)
    assert np.abs(th.grad.float().numpy() - want).max() <= GATHER_BWD_REL * np.abs(want).max()


def test_coo_segment_mean_bf16_sums_in_f32():
    """bf16 messages, in-degrees 0 to 16 and one of 1,000.  Up to 16 the
    port agrees with JAX's bf16 ``coo_segment_mean``; at 1,000 JAX's bf16
    count stops at 256 (so does its sum's precision) and its mean is several
    times the true one, where the port gives the exact mean rounded to bf16
    (ROADMAP.md, queue 3)."""
    rng = np.random.default_rng(0)
    n_src, n_dst, d = 60, 30, 16
    deg = rng.integers(0, 17, n_dst)
    deg[3], deg[5] = 0, 1000
    dst = np.repeat(np.arange(n_dst), deg).astype(np.int32)
    src = rng.integers(0, n_src, dst.size).astype(np.int32)
    hb = jnp.asarray(rng.normal(size=(n_src, d)).astype(np.float32) + 0.5, jnp.bfloat16)
    jfn = jax.jit(jmsg.coo_segment_mean, static_argnums=3)
    jout = np.asarray(jfn.lower(hb, jnp.asarray(src), jnp.asarray(dst), n_dst).compile(
        compiler_options=NO_EXCESS)(hb, jnp.asarray(src), jnp.asarray(dst)), np.float32)
    h = torch.tensor(np.asarray(hb, np.float32)).bfloat16()
    out = tmsg.coo_segment_mean(h, torch.tensor(src), torch.tensor(dst), n_dst)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    exact = np.zeros((n_dst, d))
    np.add.at(exact, dst, np.asarray(hb, np.float64)[src])
    exact /= np.maximum(deg, 1)[:, None]
    small = deg <= 16
    np.testing.assert_allclose(got[small], jout[small], rtol=0, atol=COO_ATOL)
    np.testing.assert_allclose(got, exact, rtol=GATHER_RTOL, atol=1e-6)
    assert (got[3] == 0).all()
    # JAX at in-degree 1,000: the saturated count.
    jcount = jax.ops.segment_sum(jnp.ones(dst.size, jnp.bfloat16), jnp.asarray(dst), n_dst)
    assert float(jcount[5]) == 256.0
    assert np.abs(jout[5] - exact[5]).max() > 0.5 * np.abs(exact[5]).max()


def test_recs_of_bf16_embeddings_differ_from_jax_at_near_ties_only():
    """``get_recs`` widens bf16 embeddings to f32 and ranks them exactly;
    JAX's ``cosine_score_fn`` on bf16 embeddings gives bf16 scores.  Where
    the two top-k lists differ, their items' scores under JAX's bf16
    scoring agree within ``RECS_SCORE_ATOL`` (two bf16 ulps of a score
    near 1): near-ties, not another ranking."""
    from gnn_recsys_tpu.retrieval.recs import cosine_score_fn as jcosine
    from gnn_recsys_tpu.retrieval.recs import get_recs as jget_recs
    from gnn_recsys_tpu_torch.retrieval.recs import get_recs

    rng = np.random.default_rng(3)
    users = jnp.asarray(rng.normal(size=(40, 16)), jnp.bfloat16)
    items = jnp.asarray(rng.normal(size=(300, 16)) + 0.3, jnp.bfloat16)
    uids = np.arange(0, 40, 2, dtype=np.int32)
    k = 10
    want = np.asarray(jget_recs(users, items, jnp.asarray(uids), k))
    got = get_recs(torch.tensor(np.asarray(users, np.float32)).bfloat16(),
                   torch.tensor(np.asarray(items, np.float32)).bfloat16(), uids, k,
                   backend="torch", device="cpu").numpy()
    scores = np.asarray(jcosine(users[uids], items), np.float32)
    for r in range(len(uids)):
        a, b = np.sort(scores[r, got[r]]), np.sort(scores[r, want[r]])
        assert np.abs(a - b).max() <= RECS_SCORE_ATOL, r


def test_params_of_a_bf16_jax_model_convert():
    """A bf16 JAX model's parameters are f32, as its f32 twin's: they carry
    over unchanged, and the port's bf16 model keeps them (and so Adam's
    state) f32."""
    jd, _, j32, j16, tm, jfeats, _, params = _pair()
    p16 = jfb.init_model(j16, jd.graph, jfeats, seed=0)
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(p16))
    got, want = (params_from_jax(jax.tree.map(np.asarray, p)) for p in (p16, params))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name
    tm.load_state_dict(got)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    state = tmb.TrainState.create(tm)
    assert all(p.dtype == torch.float32 for g in state.tx.param_groups for p in g["params"])


def test_dtype_argument():
    """None and f32 are the same model, on one path (f32 is stored as None);
    scores leave a bf16 model as f32; another dtype is refused."""
    kw = dict(canonical_etypes=[ET_BUYS, REVERSE_BUYS], dims=DIMS, n_layers=3,
              aggregator_type="mean_nn")
    a, b = ConvModel(**kw), ConvModel(**kw, dtype=torch.float32)
    assert a.dtype is None and b.dtype is None
    assert all(m.dtype is None for m in b.modules() if hasattr(m, "dtype"))
    feats = {"user": torch.randn(5, 8), "item": torch.randn(4, 8)}
    for nt in feats:
        assert torch.equal(a.embed[nt](feats[nt]), b.embed[nt](feats[nt]))
    m16 = ConvModel(**kw, dtype=torch.bfloat16)
    u, v = m16.embed["user"](feats["user"]), m16.embed["item"](feats["item"][:1])
    assert u.dtype == torch.bfloat16 and m16.score_emb_pairs(u, v).dtype == torch.float32
    with pytest.raises(ValueError, match="computation dtype"):
        ConvModel(**kw, dtype=torch.float16)
