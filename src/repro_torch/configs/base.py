"""Config system: architecture, shapes, partitioning, run options.

Every assigned architecture gets one file in this package exporting
``ARCH: ArchBundle`` (and ``SMOKE``, a reduced same-family config);
``get_arch`` / ``get_smoke_arch`` look them up by id.  Pure Python: the
port's own copy of the reference's dataclasses, held field for field
against them by a CPU test (``tests/test_torch_models.py``).  The mesh and
training fields (``PartitionConfig.fsdp``, ``remat``, ...) are carried as
data; the serving path reads only the attention chunk sizes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------- #
# Architecture                                                                  #
# ---------------------------------------------------------------------------- #

# mixer kinds: attn (causal full), attn_bidir, attn_local (sliding window),
#              mla (deepseek multi-head latent attention), mamba, mlstm, slstm
# ffn kinds:   mlp, moe, none


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0  # expert hidden size (d_ff of each expert)
    n_shared: int = 0  # shared (always-on) experts, deepseek-style
    renormalize: bool = True  # renormalize top-k gates to sum 1
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = no q compression (v2-lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    chunk: int = 256  # selective-scan chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk: int = 256  # mLSTM chunkwise-parallel chunk length
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "lm"  # lm | encdec
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 4096
    vocab: int = 32000
    # repeating layer group: tuple of (mixer, ffn); len must divide n_layers
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # attention details
    rope_theta: float = 1e4
    rope_local_theta: float = 1e4  # theta for attn_local layers (gemma3 10k/1M split)
    window: int = 1024  # sliding window for attn_local
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    # embeddings / norms
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm_style: str = "pre"  # pre | sandwich (gemma3)
    act: str = "silu"  # silu | gelu
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    # encoder (family == encdec): encoder reuses d_model/heads/ff unless set
    enc_layers: int = 0
    enc_pattern: Tuple[Tuple[str, str], ...] = (("attn_bidir", "mlp"),)
    dec_ratio: int = 4  # train: decoder seq = seq // dec_ratio for encdec
    # multimodal frontend stub
    modality: Optional[str] = None  # vision | audio | None
    frontend_dim: int = 0  # dim of precomputed patch/frame embeddings
    n_prefix_tokens: int = 0  # vision: number of patch tokens inside seq
    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.name, self.n_layers, self.group_size)
        return self.n_layers // self.group_size

    def param_count(self) -> Dict[str, float]:
        """Analytic parameter counts: total and active (MoE-aware), in units
        of parameters.  Used for MODEL_FLOPS in the roofline report."""
        d, hd = self.d_model, self.resolved_head_dim
        counts = {"embed": self.vocab * d * (1 if self.tie_embeddings else 2)}
        total = 0.0
        active = 0.0
        for mixer, ffn in self.pattern:
            m_params = 0.0
            if mixer in ("attn", "attn_bidir", "attn_local"):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                m_params = q + kv + o
                if mixer == "attn_bidir" and self.family == "encdec":
                    pass
            elif mixer == "mla":
                mla = self.mla
                qk_dim = mla.nope_head_dim + mla.rope_head_dim
                q = d * self.n_heads * qk_dim if not mla.q_lora_rank else (
                    d * mla.q_lora_rank + mla.q_lora_rank * self.n_heads * qk_dim)
                kv_down = d * (mla.kv_lora_rank + mla.rope_head_dim)
                k_up = mla.kv_lora_rank * self.n_heads * mla.nope_head_dim
                v_up = mla.kv_lora_rank * self.n_heads * mla.v_head_dim
                o = self.n_heads * mla.v_head_dim * d
                m_params = q + kv_down + k_up + v_up + o
            elif mixer == "mamba":
                s = self.ssm
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                m_params = (d * 2 * d_in + d_in * s.d_conv + d_in * (dt_rank + 2 * s.d_state)
                            + dt_rank * d_in + d_in * s.d_state + d_in + d_in * d)
            elif mixer in ("mlstm", "slstm"):
                x = self.xlstm
                pf = x.mlstm_proj_factor if mixer == "mlstm" else x.slstm_proj_factor
                d_in = int(pf * d)
                # up/down proj + qkv/gates approx
                m_params = 2 * d * d_in + 4 * d_in * d_in // max(1, self.n_heads)
            f_params = 0.0
            f_active = 0.0
            if ffn == "mlp":
                f_params = 3 * d * self.d_ff
                f_active = f_params
            elif ffn == "moe":
                moe = self.moe
                e_ff = moe.d_expert or self.d_ff
                f_params = moe.n_experts * 3 * d * e_ff + moe.n_shared * 3 * d * e_ff
                f_params += d * moe.n_experts  # router
                f_active = (moe.top_k + moe.n_shared) * 3 * d * e_ff + d * moe.n_experts
            total += (m_params + f_params) * self.n_groups
            active += (m_params + (f_active or f_params)) * self.n_groups
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            enc = self.enc_layers * (4 * d * self.n_heads * hd + 3 * d * self.d_ff)
            cross = self.n_layers * (4 * d * self.n_heads * hd)
            total += enc + cross
            active += enc + cross
        counts["total"] = total + counts["embed"]
        counts["active"] = active + counts["embed"]
        return counts


# ---------------------------------------------------------------------------- #
# Shapes (assigned): every LM arch gets these four cells.                       #
# ---------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------- #
# Partitioning / run options                                                    #
# ---------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    fsdp: bool = False  # shard params/optimizer over the data axis too (ZeRO-3)
    zero_stage: int = 3  # with fsdp: 3 = params+opt sharded over data;
    #                      1 = opt state only (params replicated on data:
    #                      no per-layer weight all-gather, one at update)
    seq_shard_activations: bool = False  # Megatron-SP residual sharding
    flash_decode: bool = True  # shard_map seq-sharded decode attention
    remat: str = "full"  # full | dots | none
    microbatches: int = 1  # gradient-accumulation chunks per step
    scan_layers: bool = True
    attn_chunk_q: int = 2048
    attn_chunk_kv: int = 2048
    grad_reduce: str = "allreduce"  # allreduce | reduce_scatter (ZeRO-1/2 style)
    optimizer: str = "adamw"  # adamw | adafactor


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    model: ModelConfig
    partition: PartitionConfig = PartitionConfig()
    # cells where this arch skips a shape, with reason (DESIGN.md table)
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    def skips(self, shape_name: str) -> Optional[str]:
        for s, why in self.skip_shapes:
            if s == shape_name:
                return why
        return None


_ARCH_IDS = (
    "qwen3_moe_30b_a3b",
    "deepseek_v2_lite_16b",
    "xlstm_350m",
    "qwen1_5_110b",
    "qwen3_4b",
    "gemma3_12b",
    "qwen2_5_3b",
    "internvl2_26b",
    "seamless_m4t_large_v2",
    "jamba_v0_1_52b",
)


def arch_ids() -> Tuple[str, ...]:
    return _ARCH_IDS


def get_arch(arch_id: str) -> ArchBundle:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in _ARCH_IDS and arch_id != "paper_viterbi":
        raise KeyError(f"unknown arch '{arch_id}'; known: {_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.ARCH


def get_smoke_arch(arch_id: str) -> ArchBundle:
    """Reduced same-family config for CPU smoke tests."""
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE
