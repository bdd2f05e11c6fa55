"""The 10 assigned architectures (exact published configurations).

Sources per the assignment block: recurrentgemma [arXiv:2402.19427],
mamba2 [arXiv:2405.21060], grok-1 [hf:xai-org/grok-1], mixtral
[arXiv:2401.04088], mistral-nemo [hf:mistralai/Mistral-Nemo-Base-2407],
stablelm [hf:stabilityai], minitron [arXiv:2407.14679], llama3
[arXiv:2407.21783], whisper [arXiv:2212.04356], paligemma [arXiv:2407.07726].
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

__all__ = ["ARCHS", "get_config"]


ARCHS: dict[str, ModelConfig] = {
    # hybrid: RG-LRU + local attention, pattern (R, R, local-attn)
    "recurrentgemma-9b": ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256000,
        block_pattern=("rglru", "rglru", "attn_local"), window=2048,
    ),
    # attention-free SSM (Mamba-2 SSD)
    "mamba2-370m": ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=0, vocab=50280,
        block_pattern=("ssd",),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
        tie_embeddings=True,
    ),
    # MoE 8e top-2
    "grok-1-314b": ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab=131072,
        block_pattern=("attn_full",),
        moe=MoEConfig(n_experts=8, top_k=2),
        opt_state_dtype="bfloat16",
    ),
    # MoE 8e top-2 with sliding-window attention
    "mixtral-8x22b": ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=32768,
        block_pattern=("attn_swa",), window=4096,
        moe=MoEConfig(n_experts=8, top_k=2),
        opt_state_dtype="bfloat16",
    ),
    # dense GQA, 128k ctx
    "mistral-nemo-12b": ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072,
        block_pattern=("attn_full",), rope_theta=1e6,
    ),
    # dense MHA (kv == heads)
    "stablelm-3b": ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=6912, vocab=50304,
        block_pattern=("attn_full",),
    ),
    # pruned nemotron
    "minitron-8b": ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=256000,
        block_pattern=("attn_full",),
    ),
    # frontier dense
    "llama3-405b": ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128256,
        block_pattern=("attn_full",), rope_theta=5e5,
        opt_state_dtype="bfloat16",
    ),
    # enc-dec audio backbone (conv frontend stubbed as frame embeddings)
    "whisper-tiny": ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab=51865,
        block_pattern=("attn_full",),
        enc_dec=True, n_enc_layers=4, enc_seq=1500,
        norm_eps=1e-5,
    ),
    # VLM backbone (SigLIP frontend stubbed as patch embeddings)
    "paligemma-3b": ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab=257216,
        block_pattern=("attn_full",),
        vlm_prefix=256,
        tie_embeddings=True,
    ),
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}") from None
