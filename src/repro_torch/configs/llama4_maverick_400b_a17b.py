"""Llama4-Maverick-400B-A17B [moe] — 128 routed experts top-1 + shared
expert [hf:meta-llama/Llama-4 family; unverified]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
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
        n_experts=128,
        n_experts_per_token=1,
        moe_shared_expert=True,
        moe_period=2,  # maverick interleaves dense/MoE layers
        block_pattern=("attn", "attn"),  # scan unit spans one moe period
        tie_embeddings=False,
        optimizer="adafactor",  # AdamW state (12 B/param x 400B = 4.8 TB)
        # exceeds the 4 TB single-pod HBM; factored stats fit (DESIGN.md §6)
    )
