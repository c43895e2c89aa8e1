"""The port stands alone: importing `repro_torch` and every one of its
submodules loads neither `jax` nor the JAX package `repro`, and
`chip_smoke.py` imports neither (the machine with the card has no JAX).

The import check runs in a fresh interpreter, so nothing this test
process has imported can hide or fake a dependency.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
print(" ".join(names))
"""

# the modules of each slice, which the walk must reach
SLICE_MODULES = [
    "repro_torch.kernels.ei_update.ops", "repro_torch.kernels.ei_update.ref",
    "repro_torch.core.gddim", "repro_torch.sde.vpsde",
    "repro_torch.sde.mixture", "repro_torch.train.losses",
    "repro_torch.configs.paper_ddpm", "repro_torch.launch.steps",
    "repro_torch.optim.adamw", "repro_torch.data.pipeline",
    "repro_torch.ckpt.store", "repro_torch.launch.train",
    "repro_torch.core.likelihood", "repro_torch.sde.general",
    "repro_torch.serve.traffic", "repro_torch.serve.scheduler",
    "repro_torch.serve.parking", "repro_torch.serve.router",
    "repro_torch.models.quantize", "repro_torch.models.zoo",
    "repro_torch.configs.whisper_base",
    "repro_torch.configs.qwen3_moe_30b_a3b",
    "repro_torch.configs.llama4_maverick_400b_a17b",
    "repro_torch.models.rwkv6", "repro_torch.models.ssm",
    "repro_torch.configs.rwkv6_7b", "repro_torch.configs.zamba2_2p7b",
]


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, walked = out.stdout.strip().split("\n")
    n, bad = first.split(" ", 1)
    assert int(n) >= 50, out.stdout              # every submodule was walked
    assert set(SLICE_MODULES) <= set(walked.split()), walked
    assert bad == "[]", f"the port pulled in {bad}"


def test_chip_smoke_imports_no_jax_and_no_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
