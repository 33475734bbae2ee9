"""Gemma-7B [dense] — GeGLU, head_dim=256, GQA kv=16 [arXiv:2403.08295]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        mlp_act="gelu",
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
    )
