"""internvl2-26b [arXiv:2404.16821]: InternViT frontend (STUB per assignment:
input_specs provides precomputed patch embeddings, frontend_dim=3200) +
InternLM2-20B backbone: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
256 patch tokens are prefixed inside the sequence."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="internvl2-26b",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92672,  # 92553 padded to 256-mult (TP-shardable; Megatron-style)
        pattern=(("attn", "mlp"),),
        rope_theta=1e6,
        modality="vision", frontend_dim=3200, n_prefix_tokens=256,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, microbatches=4),
    skip_shapes=(("long_500k", "pure full-attention arch (see DESIGN.md)"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="internvl2-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        rope_theta=1e4,
        modality="vision", frontend_dim=48, n_prefix_tokens=8,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
