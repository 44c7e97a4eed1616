"""Logical-axis sharding rules for the LM model zoo.

The port of ``repro/sharding/rules.py``.  Every parameter and cache
dimension carries a *logical* name; the rule table maps logical names to
mesh axes, with the reference's fallbacks: a dimension that its axes do
not divide replicates, a mesh axis the mesh lacks (``pod`` on one pod) is
dropped, and a mesh axis shards at most one dimension of a tensor (the
first to claim it).

A spec is a tuple with one entry a dimension: ``None``, a mesh axis name,
or a tuple of them (the reference's ``PartitionSpec``).  ``ShardCtx``
reads a ``torch.distributed`` ``DeviceMesh`` or a mesh *shape* alone
(``{"data": 16, "model": 16}``), which needs no process group: the dry run
(``launch/dryrun.py``) counts each device's bytes from it.  The port's
models take no ``ShardCtx`` and run on one card: the rules count, they do
not place.  ``param_shardings`` turns specs into DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dimension) for a caller that
distributes a tree with ``torch.distributed.tensor.distribute_tensor``.

The logical names of a model's parameters (``logical(cfg)``) and of its
decode cache (``cache_logical(cfg)``) mirror ``model.params()`` and
``model.cache_shapes()`` leaf for leaf.

Mesh axes (``launch/mesh.py``): ``pod`` (two pods only, outer data
parallelism), ``data`` (data parallelism and FSDP weight sharding),
``model`` (tensor, expert and cache-sequence parallelism).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "attn_seq": None,   # attention q seq (SP lever)
    "q_groups": None,   # padded head-group parallelism lever
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": None,
    "mlp": "model",
    "expert": "model",
    "d_fsdp": "data",
    "cache_seq": "model",
    "sp_seq": "model",
    "cache_batch": ("pod", "data"),
    "layer": None,
    "ssm_heads": "model",
    "ssm_state": None,
}


def _mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("ShardCtx needs a DeviceMesh with mesh_dim_names")
    return dict(zip(names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh (a ``DeviceMesh``, a ``{axis: size}`` shape, or None: every
    spec replicates) and a rule table."""

    mesh: Any = None
    rules: Tuple[Tuple[str, Axis], ...] = tuple(DEFAULT_RULES.items())

    @property
    def rule_map(self) -> Dict[str, Axis]:
        return dict(self.rules)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return _mesh_shape(self.mesh)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh_shape)

    def with_rules(self, **overrides: Axis) -> "ShardCtx":
        m = self.rule_map
        m.update(overrides)
        return ShardCtx(mesh=self.mesh, rules=tuple(m.items()))

    # -------------------------------------------------------------- mapping
    def _axis_size(self, axis: Axis) -> int:
        shape = self.mesh_shape
        if axis is None or not shape:
            return 1
        axes = (axis,) if isinstance(axis, str) else axis
        return math.prod(shape.get(a, 1) for a in axes)

    def _present(self, axis: Axis) -> Axis:
        """Drop mesh axes this mesh lacks (``pod`` on one pod)."""
        names = self.axis_names
        if axis is None or not names:
            return None
        if isinstance(axis, str):
            return axis if axis in names else None
        kept = tuple(a for a in axis if a in names)
        return kept if kept else None

    def spec(self, logical: Sequence[Optional[str]], shape=None) -> Spec:
        """The spec of a tensor with the given logical dim names.  With
        ``shape``, a dim its axes do not divide replicates; a mesh axis
        shards at most one dim (the first wins: a KV cache names both
        ``cache_seq`` and ``kv_heads``, the sequence takes ``model``)."""
        rm = self.rule_map
        out = []
        used = set()
        for i, name in enumerate(logical):
            ax = self._present(rm.get(name)) if name is not None else None
            if ax is not None and shape is not None and shape[i] % self._axis_size(ax) != 0:
                ax = None
            if ax is not None:
                axes = (ax,) if isinstance(ax, str) else tuple(ax)
                if any(a in used for a in axes):
                    ax = None
                else:
                    used.update(axes)
            out.append(ax)
        return tuple(out)

    def shards(self, spec: Spec) -> int:
        """How many devices split a tensor of this spec."""
        return math.prod(self._axis_size(ax) for ax in spec)

    def placements(self, spec: Spec):
        """DTensor placements of ``spec`` on this ctx's ``DeviceMesh``: per
        mesh dimension ``Shard(d)`` for the tensor dim ``d`` it shards,
        else ``Replicate()``.  (A dim over two mesh axes shards on both,
        outer first.)"""
        from torch.distributed.tensor import Replicate, Shard

        by_axis = {}
        for d, ax in enumerate(spec):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                by_axis[a] = Shard(d)
        return tuple(by_axis.get(a, Replicate()) for a in self.axis_names)

    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    def axis_size(self, name: str) -> int:
        return self.mesh_shape.get(name, 1)


class L:
    """Logical-axes annotation leaf: the names of one tensor's dims."""

    __slots__ = ("names",)

    def __init__(self, *names: Optional[str]):
        self.names = names

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"L{self.names}"

    def __eq__(self, other) -> bool:
        return isinstance(other, L) and other.names == self.names

    def __hash__(self) -> int:
        return hash(self.names)


def _tree_map2(fn, tree, logical_tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map2(fn, v, logical_tree[k]) for k, v in tree.items()}
    return fn(tree, logical_tree)


def param_specs(ctx: ShardCtx, params, logical_tree):
    """The spec of every leaf of ``params`` (a nested dict of tensors, or
    of anything with a ``.shape``) given a mirroring tree of ``L``."""
    return _tree_map2(lambda p, lg: ctx.spec(lg.names, tuple(p.shape)), params, logical_tree)


def param_shardings(ctx: ShardCtx, params, logical_tree):
    """DTensor placements of every leaf on ``ctx.mesh`` (a ``DeviceMesh``),
    or None when meshless."""
    if ctx.mesh is None:
        return None
    return _tree_map2(lambda p, lg: ctx.placements(ctx.spec(lg.names, tuple(p.shape))),
                      params, logical_tree)


def local_bytes(ctx: ShardCtx, tree, logical_tree=None) -> int:
    """Bytes one device holds of a nested dict of tensors: each leaf's
    bytes over the devices its spec splits it across (a tree without
    ``logical_tree`` replicates; a leaf whose ``L`` is None does too)."""
    if isinstance(tree, Mapping):
        return sum(local_bytes(ctx, v, None if logical_tree is None else logical_tree[k])
                   for k, v in tree.items())
    nbytes = tree.numel() * tree.element_size()
    if logical_tree is None:
        return nbytes
    return nbytes // ctx.shards(ctx.spec(logical_tree.names, tuple(tree.shape)))


# ------------------------------------------------------ the models' names
def _norm(kind: str, name: str = "embed") -> Dict:
    return {"scale": L(name)} if kind == "rmsnorm" else {"scale": L(name), "bias": L(name)}


def _gqa() -> Dict:
    return {"wq": L("d_fsdp", "heads", "qkv"), "wk": L("d_fsdp", "kv_heads", "qkv"),
            "wv": L("d_fsdp", "kv_heads", "qkv"), "wo": L("heads", "qkv", "d_fsdp")}


def _mla(cfg) -> Dict:
    p = {"kv_down": L("d_fsdp", None), "kv_norm": _norm("rmsnorm"),
         "k_up": L("d_fsdp", "heads", None), "v_up": L("d_fsdp", "heads", None),
         "wo": L("heads", None, "d_fsdp")}
    if cfg.q_lora_rank > 0:
        p.update(q_down=L("d_fsdp", None), q_norm=_norm("rmsnorm"),
                 q_up=L("d_fsdp", "heads", None))
    else:
        p["wq"] = L("d_fsdp", "heads", None)
    return p


def _mlp(act: str) -> Dict:
    p = {"down": L("mlp", "d_fsdp"), "up": L("d_fsdp", "mlp")}
    if act in ("swiglu", "geglu"):
        p["gate"] = L("d_fsdp", "mlp")
    return p


def _moe(cfg) -> Dict:
    p = {"router": L("d_fsdp", None), "gate": L("expert", "d_fsdp", None),
         "up": L("expert", "d_fsdp", None), "down": L("expert", None, "d_fsdp")}
    if cfg.n_shared_experts > 0:
        p["shared"] = {"gate": L("d_fsdp", "mlp"), "up": L("d_fsdp", "mlp"),
                       "down": L("mlp", "d_fsdp")}
    return p


def _mamba2(cfg) -> Dict:
    return {"wz": L("d_fsdp", "mlp"), "wx": L("d_fsdp", "mlp"), "wB": L("d_fsdp", None),
            "wC": L("d_fsdp", None), "wdt": L("d_fsdp", "ssm_heads"),
            "conv_w": L(None, "mlp"), "conv_b": L("mlp"), "A_log": L("ssm_heads"),
            "D": L("ssm_heads"), "dt_bias": L("ssm_heads"), "norm": {"scale": L("mlp")},
            "norm_in": {"scale": L("embed")}, "out": L("mlp", "d_fsdp")}


def _block(cfg, use_moe: bool, cross: bool = False) -> Dict:
    p = {"ln1": _norm(cfg.norm), "ln2": _norm(cfg.norm),
         "attn": _mla(cfg) if cfg.attn_kind == "mla" else _gqa()}
    if use_moe:
        p["moe"] = _moe(cfg)
    else:
        p["mlp"] = _mlp(cfg.act)
    if cross:
        p["ln_x"] = _norm(cfg.norm)
        p["xattn"] = _gqa()
    return p


def _stacked(tree):
    if isinstance(tree, Mapping):
        return {k: _stacked(v) for k, v in tree.items()}
    return L("layer", *tree.names)


def logical(cfg) -> Dict:
    """The logical names of ``build_model(cfg).params()``, leaf for leaf
    (the reference's ``model.logical()``)."""
    fam = cfg.family
    if fam == "encdec":
        return {"embed": {"table": L("vocab", "d_fsdp")},
                "enc_layers": _stacked(_block(cfg, False)),
                "dec_layers": _stacked(_block(cfg, False, cross=True)),
                "enc_norm": _norm(cfg.norm), "final_norm": _norm(cfg.norm),
                "unembed": L("d_fsdp", "vocab")}
    p: Dict = {"embed": {"table": L("vocab", "d_fsdp")}, "final_norm": _norm(cfg.norm)}
    if not cfg.tie_embeddings:
        p["unembed"] = L("d_fsdp", "vocab")
    if fam in ("dense", "vlm"):
        p["layers"] = _stacked(_block(cfg, False))
    elif fam == "moe":
        if cfg.first_dense_layers:
            p["dense_layers"] = _stacked(_block(cfg, False))
        p["layers"] = _stacked(_block(cfg, True))
    elif fam in ("ssm", "hybrid"):
        p["layers"] = _stacked(_mamba2(cfg))
        if fam == "hybrid":
            p["shared_attn"] = _block(cfg, False)
    else:
        raise ValueError(f"bad family {fam}")
    return p


def cache_logical(cfg) -> Dict:
    """The logical names of the decode cache, by the port's cache names
    (the hybrid's nested ``ssm/h`` is ``ssm.h``)."""
    kv = L("layer", "cache_batch", "cache_seq", "kv_heads", None)
    fam = cfg.family
    if fam == "encdec":
        return {"k": kv, "v": kv, "xk": kv, "xv": kv}
    if fam in ("ssm", "hybrid"):
        pre = "ssm." if fam == "hybrid" else ""
        out = {pre + "h": L("layer", "cache_batch", "ssm_heads", None, None),
               pre + "conv": L("layer", "cache_batch", None, "mlp")}
        if fam == "hybrid":
            out.update(k=kv, v=kv)
        return out
    if cfg.attn_kind == "mla":
        lat = L("layer", "cache_batch", "cache_seq", None)
        return {"ckv": lat, "krope": lat}
    return {"k": kv, "v": kv}
