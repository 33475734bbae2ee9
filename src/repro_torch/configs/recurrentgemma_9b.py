"""RecurrentGemma-9B [hybrid] — RG-LRU + local attention (window 2048),
pattern (R, R, A); GQA kv=1 (MQA) [arXiv:2402.19427; unverified].

38 layers = 12 scanned (R,R,A) groups + unscanned (R,R) tail.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12_288,
        vocab_size=256_000,
        attn_window=2048,
        mlp_act="gelu",
        block_pattern=("rglru", "rglru", "attn"),
        rnn_width=4096,
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
    )
