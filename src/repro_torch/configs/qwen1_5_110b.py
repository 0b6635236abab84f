"""qwen1.5-110b [hf:Qwen/Qwen1.5-*]: dense 80L d=8192 64H (GQA kv=8)
d_ff=49152 vocab=152064, QKV bias.  FSDP (ZeRO-3) sharding is on: params +
optimizer state shard over the data axis too — 110B fp32 params do not fit
replicated."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="qwen1.5-110b",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=49152, vocab=152064,
        pattern=(("attn", "mlp"),),
        rope_theta=1e6, qkv_bias=True,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, optimizer="adafactor", microbatches=8),
    skip_shapes=(("long_500k", "pure full-attention arch (see DESIGN.md)"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="qwen1.5-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512,
        pattern=(("attn", "mlp"),),
        rope_theta=1e4, qkv_bias=True,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
