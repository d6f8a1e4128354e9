"""The port imports neither JAX (nor flax, optax, orbax) nor anything of the
JAX package; only the tests import both."""

import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|gnn_recsys_tpu)\b"
    r"|__import__\(\s*['\"](jax|flax|optax|orbax|gnn_recsys_tpu)\b"
    r"|import_module\(\s*['\"](jax|flax|optax|orbax|gnn_recsys_tpu)\b",
    re.MULTILINE,
)


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gnn_recsys_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_port_never_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    offenders = []
    for path in sources:
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_pattern_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "import flax.linen as nn",
           "from gnn_recsys_tpu.graph import hetero", "import orbax.checkpoint",
           "  from optax import adam", "__import__('jax')"]
    good = ["from gnn_recsys_tpu_torch.graph import hetero", "import torch",
            "# mentions jax in a comment"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)
