"""Qwen3-1.7B [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        mlp_act="silu",
        tie_embeddings=True,
    )
