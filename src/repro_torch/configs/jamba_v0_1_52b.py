"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Jamba block = 8 layers with 1 attention : 7 Mamba and MoE every
other layer (16 experts top-2)."""
from repro_torch.configs.base import ArchBundle, MoEConfig, ModelConfig, PartitionConfig, SSMConfig

_PATTERN = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)

ARCH = ArchBundle(
    model=ModelConfig(
        name="jamba-v0.1-52b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        pattern=_PATTERN,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
        rope_theta=1e6,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, microbatches=8),
    # long_500k runs: 28/32 layers are Mamba (O(1) state); the 4 attention
    # layers use seq-sharded flash decode over the 500k cache.
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="jamba-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe")),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, chunk=16),
        rope_theta=1e4,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
