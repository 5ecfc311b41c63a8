"""Architecture registry: ``--arch <id>`` resolution for launcher,
dry-run, benchmarks and tests.  long_500k eligibility / decode support are
derived from the config (see DESIGN.md §Arch-applicability)."""
from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    deepseek_7b,
    gemma2_2b,
    llama4_maverick_400b_a17b,
    mamba2_130m,
    mistral_large_123b,
    qwen2_vl_7b,
    seamless_m4t_medium,
    yi_6b,
    zamba2_2p7b,
)
from repro_torch.configs.base import SHAPES, ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen2_vl_7b.CONFIG,
        yi_6b.CONFIG,
        deepseek_7b.CONFIG,
        mistral_large_123b.CONFIG,
        gemma2_2b.CONFIG,
        llama4_maverick_400b_a17b.CONFIG,
        dbrx_132b.CONFIG,
        mamba2_130m.CONFIG,
        seamless_m4t_medium.CONFIG,
        zamba2_2p7b.CONFIG,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells.  Skips (with reasons) follow the
    assignment rules: long_500k only for sub-quadratic archs."""
    out = []
    for name, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            skip = ""
            if sname == "long_500k" and not cfg.subquadratic:
                skip = "full-attention arch: 500k dense attention excluded per assignment"
            if include_skipped or not skip:
                out.append((cfg, shape, skip))
    return out
