"""The plain reference of a decoder-only model, in float32.

The model is the published architecture of the configuration file (its
Hugging Face keys): token embedding, ``num_hidden_layers`` layers of the
block kinds that ``reference_blocks`` names (each kind a module of this
package, found by name), a final RMSNorm and an untied unembedding. The
parameters are read in the layout the served program takes them in (one
dict a pattern position, each leaf stacked over the layers), converted a
layer at a time by ``cast``: to float32 for the reference, or through a
lower precision for the control.

It imports nothing of the program: every formula is written out here and
in the block modules. Matrix products run with TF32 off, so they are
float32 products.
"""
from __future__ import annotations

import importlib
import math

import torch

F32 = torch.float32


def dims(config: dict) -> dict:
    """The sizes the arithmetic and the reference read, from the
    configuration file's published keys."""
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    return dict(
        d=d, layers=config["num_hidden_layers"], heads=heads,
        kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or d // heads,
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        experts=config.get("num_local_experts") or 0,
        top_k=config.get("num_experts_per_tok") or 1,
        rope_theta=float(config["rope_theta"]),
        eps=float(config["rms_norm_eps"]),
        capacity_factor=config.get("assumed", {}).get(
            "moe_capacity_factor"))


def blocks(config: dict) -> list:
    """The block modules of one layer, in order."""
    return [importlib.import_module(f"{__package__}.{name}")
            for name in config["reference_blocks"]]


def leaves(config: dict) -> dict:
    """The parameter tree the served program takes, as ``(shape, scale)``
    leaves: normal draws times ``scale``. Norm scales enter as ``1 +
    scale``, so their draws are the deviations from 1."""
    m = dims(config)
    layer = {}
    for mod in blocks(config):
        layer.update(mod.leaves(m))
    v, d, n = m["vocab"], m["d"], m["layers"]
    return {"embed": ((v, d), 0.02), "final_norm": ((d,), 0.1),
            "unembed": ((v, d), 0.02),
            "blocks": [{k: ((n,) + s, sc) for k, (s, sc) in layer.items()}],
            "tail": []}


def to_f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(F32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x ``[N, T, heads, hd]`` at positions 0..T-1,
    the halves of the head dim rotated as pairs (frequency ``theta **
    (-i / (hd / 2))`` for pair i)."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] \
        * freq
    cos = torch.cos(ang).to(F32)[None, :, None, :]
    sin = torch.sin(ang).to(F32)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Context:
    """What a block needs beyond its input and weights: the sizes, the
    weight conversion, the K/V conversion (identity for the reference),
    and the token groups the served program routed together (each a range
    of positions over all sequences, sequence-major), which an expert
    layer's capacity counts over."""

    def __init__(self, m: dict, cast, kv_cast, groups):
        self.m, self.cast, self.kv_cast, self.groups = m, cast, kv_cast, \
            groups


@torch.no_grad()
def forward_logits(config: dict, params: dict, tokens: torch.Tensor,
                   judge_from: int, groups: list, cast=to_f32,
                   kv_cast=None) -> torch.Tensor:
    """f32 logits ``[N, T - judge_from, vocab]`` at positions ``judge_from
    ..T-1`` of ``tokens [N, T]``, each predicting the token after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = dims(config)
        ctx = Context(m, cast, kv_cast or (lambda t: t), groups)
        x = cast(params["embed"])[tokens.long()]
        mods = blocks(config)
        stacked = params["blocks"][0]
        for layer in range(m["layers"]):
            p = {k: w[layer] for k, w in stacked.items()}
            for mod in mods:
                x = mod.apply(x, p, ctx)
        x = rms_norm(x[:, judge_from:], params["final_norm"], m["eps"])
        w = cast(params["unembed"])
        return torch.matmul(x, w.t())
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def scale_of(hd: int) -> float:
    return 1.0 / math.sqrt(hd)
