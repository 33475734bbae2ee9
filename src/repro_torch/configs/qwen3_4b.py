"""Qwen3-4B [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        mlp_act="silu",
        tie_embeddings=True,
    )
