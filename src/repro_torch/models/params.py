"""Declarative parameter definitions: shapes and init, for one card.

Every leaf is described by a :class:`ParamDef` (its per-layer shape and
how it is initialized). Stacked-layer leaves get a leading layer dim. The
parameter tree has the reference's structure: ``embed``, ``final_norm``,
``blocks`` (one dict per pattern position, each leaf stacked
``[reps, ...]``), ``tail`` (unstacked), unless tied ``unembed``, and for
an encoder-decoder (whisper) ``enc_blocks`` (one dict, each leaf stacked
``[n_enc_layers, ...]``) and ``enc_final_norm``. An attention block of
whisper's decoder also holds its cross-attention (``xwq xwk xwv xwo
xnorm``); whisper's FFN is a gelu MLP with biases (``w1 b1 w2 b2``), an
MoE model's an expert bank behind a router (``w_router`` ``[d, E]``,
``w_gate`` / ``w_up`` ``[E, d, f]``, ``w_down`` ``[E, f, d]``).

Each ``ParamDef`` also names the dim sharded over the mesh's ``"data"``
axis (FSDP, ZeRO-3: gathered layer by layer in the forward pass) and the
dim sharded over ``"model"`` (TP), as the reference's do. Parameter
shapes stay global: only the dims that are sharded depend on the mesh
(:class:`MeshSizes`). :func:`param_pspecs` gives each leaf's partition as
a tuple of axis names (the reference's ``PartitionSpec`` as a plain
tuple), :func:`fsdp_dims` each leaf's FSDP dim in the per-layer view,
:func:`shard_params` slices a full tree into one rank's block, and
:func:`grad_sync` says how each leaf's gradient is summed across ranks.

TP rule (:meth:`MeshSizes.tp`): a dim is TP-sharded only when the mesh's
model axis divides it; otherwise compute is replicated across the model
axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import resolve_device

__all__ = ["ParamDef", "MeshSizes", "pad_vocab", "block_defs",
           "model_layout", "build_defs", "init_params", "param_structs",
           "param_pspecs",
           "fsdp_dims", "zip_map", "shard_params", "shard_leaf",
           "grad_sync"]


@dataclasses.dataclass(frozen=True)
class MeshSizes:
    data: int = 1
    model: int = 1

    def tp(self, n: int) -> int:
        return self.model if (self.model > 1 and n % self.model == 0) else 1


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]          # per-layer (unstacked) global shape
    fsdp_dim: Optional[int] = None  # dim sharded over "data"
    tp_dim: Optional[int] = None    # dim sharded over "model"
    init: str = "normal"            # normal | zeros | ones | lambda
    scale: float = 0.02
    # The reference's gradient-sync flag over "model": True where the
    # leaf is replicated over the axis but its forward consumers are
    # split over it (:func:`grad_sync`).
    model_grad: bool = False


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def _attn_defs(cfg: ModelConfig, ms: MeshSizes, cross: bool = False
               ) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = ms.tp(H) > 1
    pre = "x" if cross else ""
    return {
        f"{pre}wq": ParamDef((d, H * hd), 0, 1 if split else None,
                             scale=d ** -0.5),
        f"{pre}wk": ParamDef((d, KV * hd), 0, scale=d ** -0.5,
                             model_grad=split),
        f"{pre}wv": ParamDef((d, KV * hd), 0, scale=d ** -0.5,
                             model_grad=split),
        f"{pre}wo": ParamDef((H * hd, d), 1, 0 if split else None,
                             scale=(H * hd) ** -0.5),
        f"{pre}norm": ParamDef((d,), init="zeros", model_grad=split),
    }


def _mlp_defs(cfg: ModelConfig, ms: MeshSizes) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    split = ms.tp(f) > 1
    tpd = 1 if split else None
    if cfg.family == "audio":  # whisper: a gelu MLP with biases
        return {
            "w1": ParamDef((d, f), 0, tpd, scale=d ** -0.5),
            "b1": ParamDef((f,), None, 0 if split else None, init="zeros"),
            "w2": ParamDef((f, d), 1, 0 if split else None, scale=f ** -0.5),
            "b2": ParamDef((d,), init="zeros"),
            "norm2": ParamDef((d,), init="zeros", model_grad=split),
        }
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        return {
            "w_router": ParamDef((d, E), 0, scale=d ** -0.5,
                                 model_grad=split),
            "w_gate": ParamDef((E, d, f), 1, 2 if split else None,
                               scale=d ** -0.5),
            "w_up": ParamDef((E, d, f), 1, 2 if split else None,
                             scale=d ** -0.5),
            "w_down": ParamDef((E, f, d), 2, 1 if split else None,
                               scale=f ** -0.5),
            "norm2": ParamDef((d,), init="zeros", model_grad=split),
        }
    return {
        "w_gate": ParamDef((d, f), 0, tpd, scale=d ** -0.5),
        "w_up": ParamDef((d, f), 0, tpd, scale=d ** -0.5),
        "w_down": ParamDef((f, d), 1, 0 if split else None, scale=f ** -0.5),
        "norm2": ParamDef((d,), init="zeros", model_grad=split),
    }


def _rglru_defs(cfg: ModelConfig, ms: MeshSizes) -> dict:
    d = cfg.d_model
    w = d  # lru width = d_model
    split = ms.tp(w) > 1
    tpd = 1 if split else None
    vec = 0 if split else None
    return {
        "w1": ParamDef((d, w), 0, tpd, scale=d ** -0.5),
        "w2": ParamDef((d, w), 0, tpd, scale=d ** -0.5),
        "w_out": ParamDef((w, d), 1, vec, scale=w ** -0.5),
        "conv": ParamDef((4, w), None, tpd, scale=0.1),
        "w_a": ParamDef((w,), None, vec, scale=0.5),
        "b_a": ParamDef((w,), None, vec, init="zeros"),
        "w_x": ParamDef((w,), None, vec, scale=0.5),
        "b_x": ParamDef((w,), None, vec, init="zeros"),
        "lam": ParamDef((w,), None, vec, init="lambda"),
        "norm": ParamDef((d,), init="zeros", model_grad=split),
    }


def _ssd_defs(cfg: ModelConfig, ms: MeshSizes) -> dict:
    d = cfg.d_model
    s = cfg.ssm or SSMConfig()
    di = s.expand * d
    H = di // s.head_dim
    N = s.state_dim
    split = ms.tp(di) > 1 and ms.tp(di) == ms.tp(H)  # heads, width together
    tpd = 1 if split else None
    vec = 0 if split else None
    return {
        "w_z": ParamDef((d, di), 0, tpd, scale=d ** -0.5),
        "w_x": ParamDef((d, di), 0, tpd, scale=d ** -0.5),
        "w_bc": ParamDef((d, 2 * N), 0, scale=d ** -0.5, model_grad=split),
        "w_dt": ParamDef((d, H), 0, tpd, scale=d ** -0.5),
        "conv_x": ParamDef((s.conv_width, di), None, tpd, scale=0.1),
        "conv_b": ParamDef((s.conv_width, N), scale=0.1, model_grad=split),
        "conv_c": ParamDef((s.conv_width, N), scale=0.1, model_grad=split),
        "A_log": ParamDef((H,), None, vec, init="ones"),
        "dt_bias": ParamDef((H,), None, vec, init="zeros"),
        "D": ParamDef((H,), None, vec, init="ones"),
        "norm_g": ParamDef((di,), None, vec, init="zeros"),
        "w_out": ParamDef((di, d), 1, vec, scale=di ** -0.5),
        "norm": ParamDef((d,), init="zeros", model_grad=split),
    }


def block_defs(kind: str, cfg: ModelConfig, ms: MeshSizes = MeshSizes(),
               *, decoder: bool = False) -> dict:
    """Parameter defs for one block of the given kind: attention (with
    the cross-attention of an encoder-decoder's ``decoder``) and RG-LRU
    blocks with their FFN, SSD blocks without one."""
    if kind.startswith("attn"):
        cross = (_attn_defs(cfg, ms, cross=True)
                 if decoder and cfg.enc_dec else {})
        return {**_attn_defs(cfg, ms), **cross, **_mlp_defs(cfg, ms)}
    if kind == "rglru":
        return {**_rglru_defs(cfg, ms), **_mlp_defs(cfg, ms)}
    if kind == "ssd":
        return _ssd_defs(cfg, ms)
    raise ValueError(kind)


def model_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(n_superblock_repeats, tail_kinds)."""
    p = len(cfg.block_pattern)
    reps = cfg.n_layers // p
    tail = cfg.layer_kinds()[reps * p:]
    return reps, tail


def build_defs(cfg: ModelConfig, ms: MeshSizes = MeshSizes()) -> dict:
    """Full nested ParamDef tree (mirrors the params tree structure)."""
    _, tail = model_layout(cfg)
    vp = pad_vocab(cfg.vocab)
    tree: dict = {
        "embed": ParamDef((vp, cfg.d_model), 1, 0),
        "final_norm": ParamDef((cfg.d_model,), init="zeros",
                               model_grad=ms.model > 1),
        "blocks": [block_defs(k, cfg, ms, decoder=True)
                   for k in cfg.block_pattern],
        "tail": [block_defs(k, cfg, ms, decoder=True) for k in tail],
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = ParamDef((vp, cfg.d_model), 1, 0)
    if cfg.enc_dec:
        tree["enc_blocks"] = [block_defs("attn_full", cfg, ms)]
        tree["enc_final_norm"] = ParamDef((cfg.d_model,), init="zeros")
    return _apply_fsdp_toggle(tree, cfg)


def _apply_fsdp_toggle(defs, cfg: ModelConfig):
    """Drop FSDP sharding when ``cfg.fsdp`` is False (parameters
    replicated over "data")."""
    if cfg.fsdp:
        return defs

    def strip(d):
        if isinstance(d, ParamDef):
            return dataclasses.replace(d, fsdp_dim=None)
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()}
        return [strip(v) for v in d]

    return strip(defs)


def _map_defs(defs: dict, fn):
    """``fn(def, stacked)`` over the def tree, in the params tree's
    structure (``stacked``: the leaf has a leading layer dim)."""
    out = {}
    for name, sub in defs.items():
        if name in ("blocks", "enc_blocks", "tail"):
            out[name] = [{k: fn(d, name != "tail") for k, d in blk.items()}
                         for blk in sub]
        else:
            out[name] = fn(sub, False)
    return out


def param_pspecs(cfg: ModelConfig, ms: MeshSizes = MeshSizes(), *,
                 data_axis: Optional[str] = "data",
                 model_axis: Optional[str] = "model") -> dict:
    """Each leaf's partition: a tuple of the axis name (or None) each dim
    is sharded over, stacked leaves with a leading None (the reference's
    ``PartitionSpec`` as a tuple)."""
    def fn(d: ParamDef, stacked: bool):
        axes: list = [None] * len(d.shape)
        if d.fsdp_dim is not None and data_axis and ms.data > 1:
            axes[d.fsdp_dim] = data_axis
        if d.tp_dim is not None and model_axis and ms.model > 1:
            axes[d.tp_dim] = model_axis
        return tuple([None] + axes if stacked else axes)

    return _map_defs(build_defs(cfg, ms), fn)


def fsdp_dims(cfg: ModelConfig, ms: MeshSizes = MeshSizes()) -> dict:
    """Each leaf's FSDP dim in the per-layer view, or None: the dim the
    forward pass all-gathers over "data" before it uses a layer."""
    return _map_defs(build_defs(cfg, ms), lambda d, stacked: d.fsdp_dim)


def zip_map(fn, tree, *others):
    """``fn(leaf, *others' items at the leaf's place)`` over a parameter
    tree (dicts and lists of tensors), rebuilt with its structure; the
    other trees (specs, flags) share its dicts and lists, whatever their
    own items are."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [zip_map(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    return fn(tree, *others)


def shard_params(params: dict, cfg: ModelConfig, ms: MeshSizes,
                 coords: dict, *, data_axis: Optional[str] = "data",
                 model_axis: Optional[str] = "model") -> dict:
    """One rank's block of a full parameter tree: each leaf sliced along
    its sharded dims (:func:`param_pspecs`) at the rank's ``coords``
    (``{axis name: index}``), as contiguous tensors. A leaf not sharded
    comes back as it is."""
    specs = param_pspecs(cfg, ms, data_axis=data_axis,
                         model_axis=model_axis)
    sizes = {data_axis: ms.data, model_axis: ms.model}
    return zip_map(lambda w, spec: shard_leaf(w, spec, sizes, coords),
                   params, specs)


def shard_leaf(w: torch.Tensor, spec: tuple, sizes: dict, coords: dict
               ) -> torch.Tensor:
    """The block of ``w`` at ``coords`` under its partition ``spec`` (an
    axis name or None a dim), contiguous."""
    for dim, name in enumerate(spec):
        if name is not None:
            n = w.shape[dim] // sizes[name]
            w = w.narrow(dim, coords[name] * n, n)
    return w.contiguous()


def grad_sync(cfg: ModelConfig, ms: MeshSizes = MeshSizes()) -> dict:
    """Each leaf's gradient sync, as the reference's ``grad_sync``:
    ``data`` (the leaf is not FSDP-sharded, so its gradient is summed
    over "data"; an FSDP leaf's is summed by its gather's backward),
    ``model`` (its :attr:`ParamDef.model_grad`) and ``model_rep`` (its
    value is replicated over "model": the grad norm counts it once)."""
    return _map_defs(build_defs(cfg, ms), lambda d, stacked: {
        "data": d.fsdp_dim is None, "model": d.model_grad,
        "model_rep": d.tp_dim is None})


def _draw(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    """One layer's f32 draw: normal x scale, or the RG-LRU's Lambda, with
    ``a = exp(-8 softplus(Lambda))`` uniform in [0.9, 0.999]."""
    if d.init == "lambda":
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device) * (0.999 - 0.9) + 0.9
        x = -torch.log(u) / 8.0
        return torch.log(torch.expm1(torch.clamp(x, min=1e-8)))
    return torch.randn(d.shape, generator=gen, dtype=torch.float32,
                       device=device) * d.scale


def _leaf_init(d: ParamDef, shape, dtype, gen: torch.Generator,
               device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    # One stacked layer at a time, so the f32 draw stays one layer large.
    rows = out.reshape((-1,) + d.shape) if len(shape) > len(d.shape) else (
        out[None])
    for row in rows:
        row.copy_(_draw(d, gen, device))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters: normal x scale per leaf (zeros for the norms,
    ones for the SSD's ``A_log`` and ``D``, the RG-LRU's ``Lambda`` as the
    reference draws it), in ``cfg.param_dtype``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` = the
    card). The draws are not JAX's: the same seed gives other numbers than
    ``repro.models.params.init_params`` (carry the reference's parameters
    over with :func:`repro_torch.convert.params_from_numpy` where both must
    compute the same model)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    reps, _ = model_layout(cfg)
    defs = build_defs(cfg)

    def leaf(d: ParamDef, n_stack: int = 0):
        shape = ((n_stack,) if n_stack else ()) + d.shape
        return _leaf_init(d, shape, dtype, gen, device)

    stacks = {"blocks": reps, "enc_blocks": cfg.n_enc_layers}
    out = {k: leaf(d) for k, d in defs.items()
           if k not in ("blocks", "tail", "enc_blocks")}
    for name, n in stacks.items():
        if name in defs:
            out[name] = [{k: leaf(d, n) for k, d in blk.items()}
                         for blk in defs[name]]
    out["tail"] = [{k: leaf(d) for k, d in blk.items()}
                   for blk in defs["tail"]]
    return out


def param_structs(cfg: ModelConfig, ms: MeshSizes = MeshSizes()) -> dict:
    """The parameter tree's global shapes in ``cfg.param_dtype``, as
    empty tensors on ``meta`` (the reference's ``ShapeDtypeStruct`` s, for
    the dry run: no allocation and no draw)."""
    dtype = getattr(torch, cfg.param_dtype)
    reps, _ = model_layout(cfg)
    stacks = {"blocks": reps, "enc_blocks": cfg.n_enc_layers, "tail": 0}

    def leaf(d: ParamDef, n_stack: int = 0):
        return torch.empty(((n_stack,) if n_stack else ()) + d.shape,
                           dtype=dtype, device="meta")

    return {k: ([{n: leaf(d, stacks[k]) for n, d in blk.items()}
                 for blk in sub] if k in stacks else leaf(sub))
            for k, sub in build_defs(cfg, ms).items()}
