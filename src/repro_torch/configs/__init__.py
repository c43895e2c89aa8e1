"""Paper diffusion configs: `get_diffusion(name, reduced=False)`."""
from __future__ import annotations

import importlib
from typing import Dict

DIFFUSION_MODULES: Dict[str, str] = {
    "cifar10-cld": "paper_cld",
    "cifar10-bdm": "paper_bdm",
}


def get_diffusion(name: str, reduced: bool = False, **kw):
    if name not in DIFFUSION_MODULES:
        raise KeyError(f"unknown diffusion config {name!r}; known: "
                       f"{list(DIFFUSION_MODULES)}")
    mod = importlib.import_module(f".{DIFFUSION_MODULES[name]}", __package__)
    return mod.make(reduced=reduced, **kw)
