"""Model configuration.

``ModelConfig`` is a frozen dataclass describing an architecture exactly;
one module per assigned architecture lives next to this file and exports
``CONFIG`` (full size) and ``smoke()`` (a reduced config of the same family
that runs on the CPU).  A config carries across from ``repro.configs``
unchanged, field for field; ``activation_dtype`` names a torch dtype.

``SHAPES`` are the assigned input-shape cells; ``input_specs`` builds the
meta-tensor stand-ins for every model input of a given (arch, shape), which
the dry run (``launch/dryrun.py``) traces the real step on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

Family = Literal["dense", "moe", "vlm", "audio", "ssm", "hybrid"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    sliding_window: int = 0          # 0 = full attention
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_interval: int = 1            # MoE every k-th layer (llama4: 2), rest dense FFN
    moe_shared_expert: bool = False  # llama4: one always-on shared expert

    # VLM (cross-attention to image patch embeddings; frontend stubbed)
    cross_attn_interval: int = 0     # every k-th layer preceded by a cross block
    num_image_tokens: int = 0        # patches provided by input_specs stub

    # encoder-decoder (whisper; conv frontend stubbed -> precomputed frames)
    encoder_layers: int = 0
    num_audio_frames: int = 0
    max_position: int = 32_768       # learned decoder position table (audio family)

    # SSM / hybrid
    ssm_state: int = 0               # Mamba2 state size N
    ssm_groups: int = 1              # B/C groups (Mamba2)
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256             # SSD chunk length
    attn_every: int = 0              # zamba2: shared attn block every k ssm layers
    slstm_every: int = 0             # xlstm: every k-th block is sLSTM (rest mLSTM)

    # implementation knobs (not architecture); kept so a config carries
    # across from the reference unchanged
    attn_impl: str = "auto"          # auto | full | chunked | pallas (= the CUDA kernel)
    decode_cp: bool = False          # context-parallel decode attention
    attn_q_chunk: int = 1024         # kv-block size for chunked attention
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    logical_rules: str = "default"   # sharding rule-table name

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def activation_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports ~O(S) long-context decode (assignment rule)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        from repro_torch import common
        from repro_torch.models.registry import param_specs
        return common.param_count(param_specs(self))

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts experts_per_token of experts)."""
        from repro_torch.models.registry import param_specs
        total = 0
        for spec in param_specs(self).values():
            n = math.prod(spec.shape)
            if "experts" in spec.axes:
                e_dim = spec.shape[spec.axes.index("experts")]
                n = n * self.experts_per_token // max(e_dim, 1)
            total += n
        return total


# ---------------------------------------------------------------------------
# Assigned shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Assignment skip rules. Returns (applicable, reason-if-not)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; skipped for pure full-attention arch (see DESIGN.md)"
    return True, ""


def input_specs(cfg: ModelConfig, cell: ShapeCell, *, per_host_batch: int | None = None) -> dict:
    """Stand-ins on the ``meta`` device (no storage) for every model input
    of a given cell, in the shapes of the reference's ``jax.ShapeDtypeStruct``
    ones.  Dtypes are the port's: ``tokens``, ``labels`` and ``cache_len``
    int32 (what the port's models and data pipeline take), ``image_embeds``
    and ``audio_frames`` ``cfg.activation_dtype``.

    Modality frontends are stubs per the assignment: VLM gets precomputed
    patch embeddings, whisper gets precomputed audio-frame embeddings.
    """
    b = per_host_batch or cell.global_batch
    s = cell.seq_len
    i32, act = torch.int32, cfg.activation_dtype

    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    specs: dict = {}
    if cell.kind == "train":
        specs["tokens"] = sd((b, s), i32)
        specs["labels"] = sd((b, s), i32)
    elif cell.kind == "prefill":
        specs["tokens"] = sd((b, s), i32)
    else:  # decode: one new token against a cache of length s
        specs["tokens"] = sd((b, 1), i32)
        specs["cache_len"] = sd((), i32)
    if cfg.family == "vlm":
        specs["image_embeds"] = sd((b, cfg.num_image_tokens, cfg.d_model), act)
    if cfg.family == "audio":
        specs["audio_frames"] = sd((b, cfg.num_audio_frames, cfg.d_model), act)
    return specs
