"""Two real processes train the port's model together over gloo
(``parallel/distributed.py``), against the port in one process and the JAX
package (``tests/test_multihost.py``, ``tests/multihost_world.py``).

The parent builds JAX's world, runs JAX's single-process step (jitted, its
draws recorded in program order) and saves the parameters and draws for
the workers (``tests/torch_multihost_worker.py``, which import no JAX).
Each worker runs one GSPMD step over the global 4-entry data mesh (2 CPU
entries a process).  Tolerances are JAX's (``test_multihost.py:68-82``):
the processes' losses within rtol 1e-6 of each other, and within rtol 1e-4
of the one-process steps."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.parallel import distributed
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.train.minibatch import make_minibatch_step
from multihost_world import build_world as jax_world
from test_torch_bf16 import _recording
from torch_multihost_worker import build_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_step(path):
    """JAX's single-process step; its parameters and draws saved to ``path``."""
    state, g, feats, batch, tables, model, cfg, etypes, rng = jax_world()
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    uniforms, randints, patch = _recording()
    with patch:
        step = jmb.make_minibatch_step(model, cfg, etypes, with_update=True,
                                       with_exclusion=True,
                                       has_reverse={et: True for et in etypes})
        _, loss = step(state, g, feats, batch, tables, rng)
        jax.effects_barrier()
    arrays = {f"p:{k}": v.numpy() for k, v in params.items()}
    arrays.update({f"u:{i}": u for i, u in enumerate(uniforms)})
    arrays.update({f"r:{i}": r for i, r in enumerate(randints)})
    np.savez(path, n_u=len(uniforms), n_r=len(randints), **arrays)
    return float(loss), params, uniforms, randints


def test_two_process_step_matches_one_process(tmp_path):
    path = str(tmp_path / "inputs.npz")
    jloss, params, uniforms, randints = _jax_step(path)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_multihost_worker.py"), str(port),
         str(pid), "2", path], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    losses = []
    for out in outs:
        assert "BACKEND gloo" in out.splitlines(), out
        lines = [line for line in out.splitlines() if line.startswith("LOSS ")]
        assert lines, out
        losses.append(float(lines[0].split()[1]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)

    # The port's single-device step in this process, on the same draws.
    g, feats, batch, tables, model, cfg, etypes = build_world()
    model.load_state_dict(params)
    step = make_minibatch_step(model, cfg, etypes, with_update=True, with_exclusion=True,
                               has_reverse={et: True for et in etypes})
    _, loss = step(TrainState.create(model, lr=1e-2), g, feats, batch, tables,
                   ReplayDraws(uniforms, randints))
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
    np.testing.assert_allclose(losses[0], jloss, rtol=1e-4)


def test_initialize_multihost_single_process_and_bad_coordinator():
    distributed.initialize_multihost()  # no cluster: a no-op
    assert not dist.is_initialized()
    mesh = distributed.global_mesh(axis_names=("data",), devices=["cpu"] * 2)
    assert getattr(mesh, "processes", 1) == 1 and mesh.shape["data"] == 2
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize_multihost("127.0.0.1:1", num_processes=2)
    # Nothing listens on the coordinator's port: process 1 cannot join.
    with pytest.raises(Exception):
        distributed.initialize_multihost(f"127.0.0.1:{_free_port()}", num_processes=2,
                                         process_id=1, backend="gloo", timeout_s=3)
    assert not dist.is_initialized()


def test_global_put_single_process_and_axis_extents():
    mesh = distributed.global_mesh(axis_names=("data", "model"), data_axis=2,
                                   devices=["cpu"] * 4)
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    x = {"a": torch.arange(8)}
    blocks = distributed.global_put(mesh, x, spec="data")
    assert [b["a"].tolist() for b in blocks] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2
    assert all(torch.equal(r["a"], x["a"]) for r in distributed.global_put(mesh, x))
    assert distributed.extent(mesh, "data") == 2 and distributed.first_shard(mesh, "data") == 0
    t = [torch.ones(3)]
    assert distributed.all_reduce_sum(mesh, t) is t
