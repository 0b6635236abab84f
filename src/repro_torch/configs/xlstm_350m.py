"""xlstm-350m [arXiv:2405.04517]: 24L d=1024 4H, xLSTM[7:1] — groups of 8
blocks: 7 mLSTM + 1 sLSTM, no separate FFN (blocks carry their own
up/down projections), vocab 50304."""
from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig, XLSTMConfig

_PATTERN = tuple([("mlstm", "none")] * 7 + [("slstm", "none")])

ARCH = ArchBundle(
    model=ModelConfig(
        name="xlstm-350m",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        pattern=_PATTERN,
        xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
                          chunk=256, conv_kernel=4),
        tie_embeddings=True,
    ),
    # microbatches=4: the sequential sLSTM/mLSTM recurrences are activation-
    # heavy per token; grad accumulation bounds per-chip live activations.
    partition=PartitionConfig(remat="full", microbatches=4),
)

SMOKE = ArchBundle(
    model=ModelConfig(
        name="xlstm-smoke",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=512,
        pattern=(("mlstm", "none"), ("slstm", "none")),
        xlstm=XLSTMConfig(chunk=16),
        tie_embeddings=True,
    ),
    partition=PartitionConfig(remat="none"),
)
