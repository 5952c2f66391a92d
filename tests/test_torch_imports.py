"""Import hygiene of the port: no module of ``repro_torch`` imports JAX or
anything of the JAX package, and its entry points default to the card."""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_CHECK = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], env=env, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split()
    assert int(out[0]) >= 20  # every module of the package was imported
    assert out[1:] == ["[]"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert T.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.resolve_device(None)
    cfg = registry.get_smoke("qwen3-1.7b", num_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_model(cfg)
