"""Model substrate for serving and training: attention (self and cross) and
MLA blocks, the Mamba and xLSTM (mLSTM, sLSTM) mixers, the MLP and MoE
ffns, the decoder-only LM and encoder-decoder assemblies and the model zoo
(``build``, with the dry-run inputs ``Model.input_specs``)."""
from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
