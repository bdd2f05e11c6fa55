"""Model / shape / run configuration system.

Every assigned architecture gets a ``ModelConfig`` (exact published sizes)
plus a ``reduced()`` variant for CPU smoke tests. Input shapes are the four
assigned cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "MoEConfig", "SSMConfig"]

BlockKind = Literal["attn_full", "attn_swa", "attn_local", "rglru", "ssd"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128      # N (ssm_state)
    head_dim: int = 64        # P (mamba2 head dim)
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 256          # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # Block pattern, cycled over layers (hybrid archs mix kinds).
    block_pattern: tuple[BlockKind, ...] = ("attn_full",)
    window: int = 4096            # SWA / local attention window
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Encoder-decoder (whisper): encoder layers + stub frame inputs.
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500           # stub frame embeddings length
    # VLM (paligemma): prefix patch-embedding stub.
    vlm_prefix: int = 0           # number of stub patch embeddings
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Numerics / memory policy.
    fsdp: bool = True              # shard params over "data" (ZeRO-3 gathers)
    tp_reduce_dtype: str = "float32"  # dtype of TP partial-sum psums
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 option for very large models
    remat: bool = True
    # Serving: paged KV cache page size (tokens per page, tier-1 line size).
    page_size: int = 128
    # Whether attention is sub-quadratic (window/recurrent) => long_500k ok.

    @property
    def sub_quadratic(self) -> bool:
        return all(k != "attn_full" for k in self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> tuple[BlockKind, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def active_params(self) -> int:
        """Parameter count, counting only top_k experts for MoE (for the
        MODEL_FLOPS = 6·N_active·D roofline convention)."""
        return self._param_count(active_only=True)

    def total_params(self) -> int:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> int:
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        n = 0
        kinds = self.layer_kinds()
        for k in kinds:
            if k.startswith("attn"):
                n += d * self.n_heads * hd          # q
                n += 2 * d * self.n_kv_heads * hd   # k, v
                n += self.n_heads * hd * d          # o
            elif k == "rglru":
                w = d  # lru width == d_model
                n += 2 * d * w + 2 * w + w * d      # in/gate projs, gates, out
                n += 2 * d * w                      # conv-ish branch proj
            elif k == "ssd":
                s = self.ssm or SSMConfig()
                di = s.expand * d
                nh = di // s.head_dim
                n += d * (2 * di + 2 * nh * s.state_dim + nh)  # in_proj fused
                n += di * d                          # out proj
            if k.startswith("attn") or k == "rglru":
                if self.moe is not None:
                    e = self.moe.top_k if active_only else self.moe.n_experts
                    n += e * 3 * d * f + d * self.moe.n_experts  # experts + router
                elif f > 0:
                    n += 3 * d * f
            n += 2 * d  # norms
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.enc_dec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn.
            enc = self.n_enc_layers * (
                d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d + 3 * d * f + 2 * d
            )
            xattn = self.n_layers * (
                d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d + d
            )
            n += enc + xattn
        return n

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(len(self.block_pattern), 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            window=32,
            moe=None if self.moe is None else dataclasses.replace(
                self.moe, n_experts=4, top_k=2
            ),
            ssm=None if self.ssm is None else dataclasses.replace(
                self.ssm, state_dim=16, head_dim=8, chunk=16
            ),
            n_enc_layers=2 if self.enc_dec else 0,
            enc_seq=24 if self.enc_dec else self.enc_seq,
            vlm_prefix=8 if self.vlm_prefix else 0,
            page_size=16,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
