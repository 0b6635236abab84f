"""qwen3-4b [hf:Qwen/Qwen3-*]: dense 36L d=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk-norm."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="qwen3-4b",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab=151936,
        pattern=(("attn", "mlp"),),
        rope_theta=1e6, qk_norm=True,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, microbatches=2),
    skip_shapes=(("long_500k", "pure full-attention arch (see DESIGN.md)"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="qwen3-4b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        rope_theta=1e4, qk_norm=True,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
