"""Model and paper configs: `get_arch(name, reduced=False)` for every token
arch of the JAX package (the dense and MoE transformers, rwkv6-7b,
zamba2-2.7b and whisper-base's encoder-decoder, which the token engine
serves and `launch.train.train_lm` trains), `get_diffusion(name,
reduced=False)` for the paper's diffusion configs.  `ARCH_IDS` keeps the
JAX package's order."""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_MODULES: Dict[str, str] = {
    "zamba2-2.7b": "zamba2_2p7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama3-405b": "llama3_405b",
    "gemma3-1b": "gemma3_1b",
    "nemotron-4-15b": "nemotron_4_15b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "whisper-base": "whisper_base",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS: List[str] = list(ARCH_MODULES)

DIFFUSION_MODULES: Dict[str, str] = {
    "cifar10-cld": "paper_cld",
    "cifar10-bdm": "paper_bdm",
    "cifar10-ddpm": "paper_ddpm",
}


def get_arch(name: str, reduced: bool = False, **kw):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(f".{ARCH_MODULES[name]}", __package__)
    return mod.make(reduced=reduced, **kw)


def get_diffusion(name: str, reduced: bool = False, **kw):
    if name not in DIFFUSION_MODULES:
        raise KeyError(f"unknown diffusion config {name!r}; known: "
                       f"{list(DIFFUSION_MODULES)}")
    mod = importlib.import_module(f".{DIFFUSION_MODULES[name]}", __package__)
    return mod.make(reduced=reduced, **kw)
