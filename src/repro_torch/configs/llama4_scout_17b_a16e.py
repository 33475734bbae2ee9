"""Llama4-Scout-17B-16E [moe] — 16 routed experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        rope_theta=500_000.0,
        mlp_act="silu",
        n_experts=16,
        n_experts_per_token=1,
        moe_shared_expert=True,
        tie_embeddings=False,
    )
