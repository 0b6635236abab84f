"""Gated MLP (SwiGLU / GeGLU); ``mlp_apply_tp`` runs it over model shards
(``gate``/``up`` column parallel, ``down`` row parallel over ff)."""
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


def mlp_apply_tp(ps, cfg, xs, group, d_ff: int = 0):
    """``mlp_apply`` over the model shards of ``group`` (``ps`` each shard's
    block of the parameters, ``xs`` the replicated input): where ff is
    split (a block narrower than ``d_ff or cfg.d_ff``) each shard's
    activations of its ff columns into its rows of ``down``, summed; else
    the whole MLP once a device."""
    cd = cm.dtype_of(cfg.compute_dtype)
    act = cm.activation(cfg.act)
    split = ps[0]["gate"]["kernel"].shape[-1] < (d_ff or cfg.d_ff)

    def up(p, x):
        return act(cm.dense(p["gate"], x, "...d,df->...f", cd)) * cm.dense(
            p["up"], x, "...d,df->...f", cd)

    hs = (group.each if split else group.once)(up, ps, xs)
    return cm.dense_row_parallel(group, [p["down"] for p in ps], hs, "...f,fd->...d", cd, split)
