"""MusicGen-Large [audio] — decoder-only over EnCodec tokens, 4 codebooks
(summed embeddings, per-codebook heads); EnCodec frontend stubbed
[arXiv:2306.05284]. RoPE substitutes the original sinusoidal embedding
(positional scheme is not the assigned contract; noted in DESIGN.md)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        mlp_act="gelu",
        n_codebooks=4,
        tie_embeddings=False,
    )
