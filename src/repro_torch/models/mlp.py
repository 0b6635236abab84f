"""Gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

from repro_torch.models import common as cm


def mlp_specs(cfg, stack: int, d_ff: int = 0):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "gate": cm.dense_spec((d,), (ff,), ("embed",), ("ff",), stack=stack),
        "up": cm.dense_spec((d,), (ff,), ("embed",), ("ff",), stack=stack),
        "down": cm.dense_spec((ff,), (d,), ("ff",), ("embed",), stack=stack),
    }


def mlp_apply(params, cfg, x):
    cd = cm.dtype_of(cfg.compute_dtype)
    act = cm.activation(cfg.act)
    g = cm.dense(params["gate"], x, "...d,df->...f", cd)
    u = cm.dense(params["up"], x, "...d,df->...f", cd)
    return cm.dense(params["down"], act(g) * u, "...f,fd->...d", cd)
