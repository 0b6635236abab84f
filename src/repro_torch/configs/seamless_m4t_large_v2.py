"""seamless-m4t-large-v2 [arXiv:2308.11596]: encoder-decoder, 24L encoder +
24L decoder, d=1024 16H (kv=16) d_ff=8192 vocab=256206.  The audio frontend
is a STUB per the assignment: input_specs provides precomputed frame
embeddings (frontend_dim=1024).  Decoder seq = seq_len // dec_ratio at
train/prefill; decode runs one token against self + cross caches of
seq_len."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig

ARCH = ArchBundle(
    model=ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=8192, vocab=256256,  # 256206 padded to 256-mult (TP-shardable)
        pattern=(("attn", "mlp"),),
        rope_theta=1e4,
        modality="audio", frontend_dim=1024, dec_ratio=4,
    ),
    partition=PartitionConfig(remat="full"),
    skip_shapes=(("long_500k", "full-attention enc-dec (see DESIGN.md)"),),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="seamless-smoke",
        family="encdec",
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        rope_theta=1e4,
        modality="audio", frontend_dim=32, dec_ratio=4,
    ),
    partition=PartitionConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32),
)
