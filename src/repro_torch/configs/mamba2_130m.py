"""Mamba2-130M [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,  # unused (attention-free)
        n_kv_heads=1,
        head_dim=1,
        d_ff=0,
        vocab_size=50_280,
        block_pattern=("mamba",),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        tie_embeddings=True,
    )
