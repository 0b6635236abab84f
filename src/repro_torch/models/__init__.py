"""Model substrate for serving: attention blocks, the decoder-only LM
assembly and the model zoo (``build``).  The other mixers (mla, mamba,
xLSTM), MoE, the encoder-decoder family and training wait for ROADMAP
item 11."""
from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
