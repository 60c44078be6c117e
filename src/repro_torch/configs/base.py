"""Architecture config schema, input-shape suite and the arch registry
(port of ``repro.configs.base``).

The dataclasses are copies of the reference's, field for field, with one
deliberate difference: ``attention_impl`` takes ``"flash"`` (kernel 6,
``csrc/flash_attention.cu``, on the card; its plain twin on the CPU) or
``"plain"`` (the masked einsum), and defaults to ``"flash"`` because the
card is the port's target.  They stand for the reference's
``"flash_pallas"`` and ``"xla"``.

granite-20b, qwen3-4b and xlstm-1.3b are ported so far; every other arch
id raises ``NotImplementedError`` naming the slice that brings it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ATTENTION_IMPLS = ("flash", "plain")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPE_SUITE: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_SUITE:
        if c.name == name:
            return c
    raise KeyError(f"unknown shape cell {name!r}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (exact public-literature config)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA width ("swa" blocks)
    local_window: Optional[int] = None  # local-attention width ("local" blocks)
    # Block pattern cycled over num_layers: attn | swa | local | mlstm | slstm | rglru
    block_pattern: Tuple[str, ...] = ("attn",)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # Recurrent widths
    rnn_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    # Encoder-decoder / modality frontend
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    frontend: Optional[str] = None  # audio_stub | patch_stub
    frontend_len: int = 0
    # Numerics / impl
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    attention_impl: str = "flash"  # flash (kernel 6) | plain (masked einsum)
    notes: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if serve_step cost per token is o(seq_len) state reads."""
        return self.family in ("ssm", "hybrid")

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        if self.num_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {self.pattern_period}"
            )
        return self.num_layers // self.pattern_period

    def supports_cell(self, cell: ShapeCell) -> tuple[bool, str]:
        """Whether this (arch x shape) cell runs, and why not if skipped."""
        if cell.name == "long_500k" and not self.sub_quadratic:
            return False, (
                "long_500k needs sub-quadratic attention; "
                f"{self.name} is full-attention ({self.family}) — skipped per assignment"
            )
        return True, ""

    def validate(self) -> None:
        checks = [
            (self.num_heads % self.num_kv_heads == 0, "num_heads % num_kv_heads"),
            (self.num_layers % len(self.block_pattern) == 0, "num_layers % period"),
            (not self.is_moe or self.experts_per_token in (1, 2), "experts_per_token"),
            ("rglru" not in self.block_pattern or self.rnn_width > 0, "rnn_width"),
            (not self.is_encoder_decoder or self.encoder_layers > 0, "encoder_layers"),
            (self.attention_impl in ATTENTION_IMPLS,
             f"attention_impl {self.attention_impl!r} not in {ATTENTION_IMPLS}"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"{self.name}: invalid config ({what})")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
ARCH_IDS = (
    "granite_20b",
    "qwen3_4b",
    "llama3_405b",
    "qwen3_14b",
    "grok_1_314b",
    "mixtral_8x22b",
    "xlstm_1_3b",
    "recurrentgemma_9b",
    "pixtral_12b",
    "whisper_base",
)
PORTED_ARCHS = ("granite_20b", "qwen3_4b", "xlstm_1_3b")
# The slice of the port that brings each arch not ported yet.
LATER_ARCH_SLICE = {
    "llama3_405b": "the multi-card LM slice (sharded weights)",
    "qwen3_14b": "the dense-LM slice after qwen3",
    "grok_1_314b": "the MoE slice",
    "mixtral_8x22b": "the MoE and swa ring-cache slices",
    "recurrentgemma_9b": "the Griffin slice (rglru blocks, local ring caches)",
    "pixtral_12b": "the VLM slice (patch-embedding prefix)",
    "whisper_base": "the encoder-decoder slice",
}


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: it belongs to {LATER_ARCH_SLICE[arch]}"
        )
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    """The arch's full-width CONFIG."""
    cfg: ArchConfig = _module(arch).CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg: ArchConfig = _module(arch).SMOKE_CONFIG
    cfg.validate()
    return cfg
