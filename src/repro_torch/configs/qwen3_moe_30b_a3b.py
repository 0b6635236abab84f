"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4)
MoE 128 experts top-8, expert d_ff=768, vocab 151936, qk-norm."""
from repro_torch.configs.base import ArchBundle, MoEConfig, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="qwen3-moe-30b-a3b",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936,
        pattern=(("attn", "moe"),),
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
        rope_theta=1e6, qk_norm=True,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, microbatches=4),
    skip_shapes=(("long_500k", "pure full-attention arch (see DESIGN.md)"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="qwen3-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=512,
        pattern=(("attn", "moe"),),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32),
        rope_theta=1e4, qk_norm=True,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
