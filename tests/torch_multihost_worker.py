"""Worker process of ``tests/test_torch_multihost.py``: one of two processes
that train the port's model together over gloo.

    python tests/torch_multihost_worker.py <port> <process_id> <num_processes> <inputs.npz>

It imports nothing of JAX.  Each process joins the group at
``127.0.0.1:<port>``, builds the global ('data',) mesh of its 2 CPU entries
(4 data shards over both processes), builds the world of
``tests/multihost_world.py`` with the port, loads the parameters and the
single-device step's draws from ``inputs.npz``, and runs one step of
``make_gspmd_minibatch_step``.  Prints ``BACKEND <name>`` and ``LOSS
<value>``.
"""

import sys

import numpy as np
import torch

ET = ("user", "buys", "item")
ETC = ("user", "clicks", "item")
BATCH = 16


def build_world():
    """The port's twin of ``tests/multihost_world.py:build_world``."""
    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
    from gnn_recsys_tpu_torch.train.minibatch import MinibatchConfig
    from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

    data = make_synthetic_data(num_users=32, num_items=16, num_groups=2, interactions_per_user=6,
                               with_clicks=True, seed=7)
    g = data.graph
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 8), ("out", 8)),
                      n_layers=2, aggregator_type="mean", pred="cos")
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    cfg = MinibatchConfig(edge_batch_size=2 * BATCH, fanouts=(2,), neg_sample_size=4,
                          neg_mode="shared_pool", neg_pool_size=8)
    etypes = (ET, ETC)
    batch = {et: {"u": g.rels[et].src[:BATCH].long(), "i": g.rels[et].dst[:BATCH].long(),
                  "recency": torch.ones(BATCH), "eids": torch.arange(BATCH)} for et in etypes}
    tables = {et: build_padded_pair_set(g.rels[et].src.numpy(), g.rels[et].dst.numpy(),
                                        num_src=g.num_nodes("user")) for et in etypes}
    return g, feats, batch, tables, model, cfg, etypes


def load_inputs(path):
    """(state_dict, uniforms, randints) saved by the parent test."""
    z = np.load(path)
    params = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("p:")}
    uniforms = [z[f"u:{i}"] for i in range(int(z["n_u"]))]
    randints = [z[f"r:{i}"] for i in range(int(z["n_r"]))]
    return params, uniforms, randints


def main() -> None:
    port, pid, nprocs, inputs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
    from gnn_recsys_tpu_torch.parallel.distributed import (
        global_mesh,
        global_put,
        initialize_multihost,
    )
    from gnn_recsys_tpu_torch.parallel.sharded import make_gspmd_minibatch_step
    from gnn_recsys_tpu_torch.train.full_batch import TrainState

    initialize_multihost(f"127.0.0.1:{port}", nprocs, pid, backend="gloo", timeout_s=120)
    initialize_multihost(f"127.0.0.1:{port}", nprocs, pid, backend="gloo")  # a no-op
    mesh = global_mesh(axis_names=("data",), devices=["cpu", "cpu"])
    assert mesh.processes == nprocs and mesh.process_index == pid, mesh
    g, feats, batch, tables, model, cfg, etypes = build_world()
    # Each process keeps only its own data shards' blocks.
    blocks = global_put(mesh, batch, spec="data")
    for j, b in enumerate(blocks):
        lo = (pid * 2 + j) * (BATCH // 4)
        assert torch.equal(b[ET]["eids"], torch.arange(lo, lo + BATCH // 4)), (pid, j)
    params, uniforms, randints = load_inputs(inputs)
    model.load_state_dict(params)
    state = TrainState.create(model, lr=1e-2)
    step = make_gspmd_minibatch_step(model, cfg, etypes, mesh)
    draws = ReplayDraws(uniforms, randints)
    _, loss = step(state, g, feats, batch, tables, draws)
    assert draws.exhausted and state.step == 1
    print(f"BACKEND {mesh.backend}", flush=True)
    print(f"LOSS {float(loss):.8f}", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
