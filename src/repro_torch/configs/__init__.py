"""Architecture registry: ``get_config(arch_id)``.

Each <id>.py holds the exact published config, copied from
``src/repro/configs/`` (pure data). ``shapes.py`` holds the input-shape
cells of the (arch × shape) matrix that ``launch/dryrun.py`` walks.
"""

from importlib import import_module

ARCH_IDS = (
    "qwen3_1_7b",
    "gemma_7b",
    "deepseek_coder_33b",
    "qwen3_4b",
    "llama4_maverick_400b_a17b",
    "llama4_scout_17b_a16e",
    "mamba2_130m",
    "recurrentgemma_9b",
    "internvl2_26b",
    "musicgen_large",
)

# public ids use dashes (CLI: --arch qwen3-1.7b)
_ALIASES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma-7b": "gemma_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-4b": "qwen3_4b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-26b": "internvl2_26b",
    "musicgen-large": "musicgen_large",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str):
    mod = import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.config()


def all_arch_names() -> tuple[str, ...]:
    return tuple(_ALIASES.keys())
