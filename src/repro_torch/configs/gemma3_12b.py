"""gemma3-12b [hf:google/gemma-3-*]: 48L d=3840 16H (GQA kv=8) head_dim=256
d_ff=15360 vocab=262144; 5:1 local(window 1024):global attention, RoPE theta
10k local / 1M global, sandwich norms, tied embeddings with sqrt(d) scaling."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig

_PATTERN = tuple([("attn_local", "mlp")] * 5 + [("attn", "mlp")])

ARCH = ArchBundle(
    model=ModelConfig(
        name="gemma3-12b",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=15360, vocab=262144,
        pattern=_PATTERN,
        window=1024, rope_theta=1e6, rope_local_theta=1e4,
        qk_norm=True, norm_style="sandwich", act="gelu",
        tie_embeddings=True, embed_scale=True,
    ),
    partition=PartitionConfig(remat="full", fsdp=True, microbatches=8),
    # long_500k runs: 40/48 layers are window-1024; the 8 global layers use
    # seq-sharded flash decode over the 500k cache.
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="gemma3-smoke",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=_PATTERN,
        window=16, rope_theta=1e6, rope_local_theta=1e4,
        qk_norm=True, norm_style="sandwich", act="gelu",
        tie_embeddings=True, embed_scale=True,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
