"""Fixtures of the benchmark's tests: a copy of the benchmark at a tiny
size that runs on the CPU, and the card for the tests marked ``cuda``."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(root: Path) -> None:
    """Cut the copy's configuration and traffic to sizes a test holds."""
    for cfg in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        c["graph"].update(num_users=300, num_items=120, num_groups=5, interactions_per_user=4,
                          max_fanout=8)
        c["model"].update(hidden_dim=32, out_dim=16)
        if "step" in c:  # a training configuration
            c["step"].update(edge_batch_size=64, neg_pool_size=50, epoch_chunk_steps=4,
                             neg_sample_size=min(c["step"]["neg_sample_size"], 40))
            if min(c["step"]["fanouts"]) > 0:  # sampled: fewer slots; full rows stay
                c["step"]["fanouts"] = [3, 2][:len(c["step"]["fanouts"])]
        cfg.write_text(json.dumps(c))
    for tr in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(tr.read_text())
        if "users_max" in t:
            t["users_max"] = 200
        tr.write_text(json.dumps(t))


def copy_benchmark(dest: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_benchmark(tmp_path)
    shrink(root)
    return root


@pytest.fixture
def one_thread():
    import torch

    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
