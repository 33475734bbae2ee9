"""InternVL2-26B [vlm] — InternLM2-26B language backbone; InternViT
frontend is a STUB: input_specs() supplies 256 precomputed patch
embeddings per image (assignment contract) [arXiv:2404.16821]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        vocab_size=92_553,
        mlp_act="silu",
        n_prefix_embeds=256,
        tie_embeddings=False,
    )
