"""The port's sharding rules against the reference's: the reference's
``TestShardCtx`` cases on the port's ``ShardCtx`` (a mesh shape alone, no
process group), then every smoke arch's parameter and decode-cache specs
equal to the reference's ``PartitionSpec``s on the (16, 16) and
(2, 16, 16) meshes (the reference's over a ``jax.sharding.AbstractMesh``,
which needs no devices), and the DTensor placements on a ``DeviceMesh``
over a fake 256-rank group."""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import decode_specs as j_decode_specs
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import build_model as j_build_model
from repro.sharding.rules import ShardCtx as JShardCtx
from repro.sharding.rules import param_specs as j_param_specs
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import fake_world, make_production_mesh, production_shape
from repro_torch.models import build_model
from repro_torch.sharding import (
    DEFAULT_RULES,
    L,
    ShardCtx,
    cache_logical,
    local_bytes,
    logical,
    param_shardings,
    param_specs,
)

MESHES = {"pod": production_shape(False), "multipod": production_shape(True)}


def _norm(ax):
    """One spec entry as the reference's PartitionSpec holds it: a 1-tuple
    of axes is that axis."""
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _as_tuple(spec):
    return tuple(_norm(ax) for ax in spec)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


class TestShardCtx:
    def test_meshless_is_noop(self):
        ctx = ShardCtx()
        assert ctx.axis_size("model") == 1
        assert ctx.batch_axes() == ()
        assert ctx.shards(ctx.spec(("batch", "heads"), (4, 4))) == 1

    def test_spec_basic(self):
        assert ShardCtx().spec(("batch", "seq", "mlp")) == (None, None, None)  # no mesh

    def test_rules_override(self):
        ctx = ShardCtx().with_rules(seq="model")
        assert ctx.rule_map["seq"] == "model"
        assert ctx.rule_map["batch"] == ("pod", "data")
        assert dict(ShardCtx().rules) == DEFAULT_RULES

    def test_divisibility_fallback_and_pod_drop(self):
        ctx = ShardCtx(mesh={"data": 1, "model": 1})
        spec = ctx.spec(("batch", "heads"), shape=(4, 40))
        assert _norm(spec[0]) == "data"  # 'pod' is missing on this mesh: dropped
        assert spec[1] == "model"  # 40 % 1 == 0: kept
        pod = ShardCtx(mesh=MESHES["pod"])
        assert pod.spec(("batch", "heads"), shape=(4, 40)) == (None, None)  # neither divides
        assert _norm(pod.spec(("batch", "heads"), shape=(32, 48))[0]) == "data"
        assert pod.spec(("batch", "heads"), shape=(32, 48))[1] == "model"

    def test_an_axis_shards_one_dim(self):
        ctx = ShardCtx(mesh=MESHES["pod"])
        spec = ctx.spec(("layer", "cache_batch", "cache_seq", "kv_heads", None),
                        (3, 128, 32768, 16, 128))
        assert _as_tuple(spec) == (None, "data", "model", None, None)

    def test_L_leaves_mirror_a_tree(self):
        tree = {"a": torch.empty(32, 64, device="meta"), "b": {"c": torch.empty(48, device="meta")}}
        names = {"a": L("vocab", "d_fsdp"), "b": {"c": L("mlp")}}
        ctx = ShardCtx(mesh=MESHES["pod"])
        assert param_specs(ctx, tree, names) == {"a": ("model", "data"), "b": {"c": ("model",)}}
        assert local_bytes(ctx, tree, names) == 32 * 64 * 4 // 256 + 48 * 4 // 16
        assert local_bytes(ctx, tree) == (32 * 64 + 48) * 4  # no names: replicated


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg = get_smoke_config(arch)
    params = build_model(cfg, "meta").params()
    got = _flat(param_specs(ShardCtx(mesh=MESHES[mesh]), params, logical(cfg)))

    jm = j_build_model(j_smoke(arch))
    sds = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    shape = MESHES[mesh]
    jctx = JShardCtx(mesh=AbstractMesh(tuple(shape.values()), tuple(shape)))
    want = _flat(j_param_specs(jctx, sds, jm.logical()))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert _as_tuple(got[k]) == tuple(w), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_reference(arch, mesh):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "meta")
    # A decode shape whose batch and sequence the meshes' axes divide.
    shape = ShapeConfig("decode", 2048, 64, "decode")
    from repro_torch.configs import decode_specs

    cache = decode_specs(cfg, shape, model)["cache"]
    got = param_specs(ShardCtx(mesh=MESHES[mesh]), cache, cache_logical(cfg))

    jcfg = j_smoke(arch)
    jm = j_build_model(jcfg)
    jcache = j_decode_specs(jcfg, JShapeConfig("decode", 2048, 64, "decode"), jm)["cache"]
    ms = MESHES[mesh]
    jctx = JShardCtx(mesh=AbstractMesh(tuple(ms.values()), tuple(ms)))
    want = _flat(j_param_specs(jctx, jcache, jm.cache_logical()))
    want = {k.replace("/", "."): v for k, v in want.items()}  # the hybrid's ssm/h is ssm.h
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert _as_tuple(got[k]) == tuple(w), k


def test_param_shardings_place_on_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_smoke_config("yi-9b")
    params = build_model(cfg, "meta").params()
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        ctx = ShardCtx(mesh=mesh)
        assert ctx.mesh_shape == MESHES["pod"]
        placed = param_shardings(ctx, params, logical(cfg))
    # embed/table (vocab, d): vocab over model, d over data.
    assert placed["embed"]["table"] == (Shard(1), Shard(0))
    # a norm scale (layer, d): 'embed' maps to no axis.
    assert placed["final_norm"]["scale"] == (Replicate(), Replicate())
    assert param_shardings(ShardCtx(), params, logical(cfg)) is None
