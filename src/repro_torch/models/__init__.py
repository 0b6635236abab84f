"""Model substrate for serving and training: attention and MLA blocks, the
Mamba and xLSTM (mLSTM, sLSTM) mixers, the MLP and MoE ffns, the
decoder-only LM assembly and the model zoo (``build``).  The
encoder-decoder family and the dry-run inputs wait for ROADMAP item 11."""
from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
