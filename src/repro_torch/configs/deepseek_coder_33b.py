"""DeepSeek-Coder-33B [dense] — llama-arch, GQA kv=8 [arXiv:2401.14196]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19_200,
        vocab_size=32_256,
        rope_theta=100_000.0,
        mlp_act="silu",
        tie_embeddings=False,
    )
