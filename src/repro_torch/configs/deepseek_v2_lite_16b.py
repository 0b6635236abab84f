"""deepseek-v2-lite-16b [arXiv:2405.04434]: 27L d=2048 16H, MLA kv_lora=512
(rope 64 / nope 128 / v 128), MoE 64 routed top-6 + 2 shared, expert
d_ff=1408, vocab 102400.  (The real model's dense first layer is simplified
to a uniform MoE stack — noted in DESIGN.md §Arch-applicability.)"""
from repro_torch.configs.base import ArchBundle, MLAConfig, MoEConfig, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
        d_ff=1408, vocab=102400,
        pattern=(("mla", "moe"),),
        mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
        rope_theta=1e4,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, microbatches=4),
    skip_shapes=(("long_500k", "MLA is full attention over compressed KV"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="deepseek-v2-lite-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=32, vocab=512,
        pattern=(("mla", "moe"),),
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1),
        rope_theta=1e4,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
