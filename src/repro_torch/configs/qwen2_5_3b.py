"""qwen2.5-3b [hf:Qwen/Qwen2.5-*]: dense 36L d=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936, QKV bias, tied embeddings."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="qwen2.5-3b",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab=151936,
        pattern=(("attn", "mlp"),),
        rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
    ),
    partition=PartitionConfig(remat="full"),
    skip_shapes=(("long_500k", "pure full-attention arch (see DESIGN.md)"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="qwen2.5-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        rope_theta=1e4, qkv_bias=True, tie_embeddings=True,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
