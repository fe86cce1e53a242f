"""``repro_torch.models.partitioning`` and ``repro_torch.launch.mesh``
against the reference's ``repro.models.partitioning`` on the CPU.

Default rules for each mesh's axis names, ``spec``, the spec-to-placements
map, ``use_mesh`` nesting and restore, ``shard`` as a no-op without a mesh
and for plain tensors, a DTensor redistributed by ``shard`` on a world of
one, ``distribute`` keeping plain tensors on a world of one, and the
meshes: the production mesh's rank count check and the host mesh of a
world of one (gloo, ``HashStore``).
"""
import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.models import partitioning as jp
from repro_torch.launch import mesh as tmesh
from repro_torch.models import partitioning as tp
from repro_torch.models import set_mesh, shard, use_mesh

AXES = {"none": None, "16x16": ((16, 16), ("data", "model")),
        "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
        "data": ((8,), ("data",)), "model": ((4,), ("model",))}
NAMES = ("batch", "seq", "dec_seq", "embed", "heads", "kv", "head_dim", "ff", "experts",
         "expert_cap", "vocab", "kv_seq", "state", "layers", "frames")


def _meshes(name):
    if AXES[name] is None:
        return None, None
    shape, axes = AXES[name]
    return tp.AbstractMesh(shape, axes), jax.sharding.AbstractMesh(shape, axes)


@pytest.mark.parametrize("name", sorted(AXES))
def test_default_rules_match_reference(name):
    mesh, jmesh = _meshes(name)
    assert tp.default_rules(mesh) == jp.default_rules(jmesh)
    assert set(tp.default_rules(mesh)) == set(NAMES)


@pytest.mark.parametrize("rules", [None, {"experts": "data"}, {"kv": "model", "kv_seq": None}])
@pytest.mark.parametrize("name", ["16x16", "2x16x16"])
def test_spec_matches_reference(name, rules):
    mesh, jmesh = _meshes(name)
    jp.set_mesh(jmesh, rules)   # the reference's use_mesh enters a concrete mesh
    try:
        _same_specs(mesh, rules)
    finally:
        jp.set_mesh(None)


def _same_specs(mesh, rules):
    with use_mesh(mesh, rules):
        for axes in (("batch", "seq", "embed"), ("batch", "seq", "heads", "head_dim"),
                     ("experts", "expert_cap", "embed"), ("batch", None, None, "embed"),
                     ("batch", "kv_seq", "kv", "head_dim"), ("batch", "seq", "vocab")):
            assert tuple(tp.spec(*axes)) == tuple(jp.spec(*axes)), axes
            assert tp.named_sharding(*axes) == (mesh, tp.placements(tp.spec(*axes), mesh))


def test_placements_of_a_spec():
    mesh = tp.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tp.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert tp.placements((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert tp.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="shards two dims"):
        tp.placements(("model", "model"), mesh)
    assert tuple(tp.fit(("model", ("pod", "data")), (30, 64), mesh)) == (None, ("pod", "data"))


def test_use_mesh_nests_and_restores():
    outer, _ = _meshes("16x16")
    inner, _ = _meshes("2x16x16")
    assert tp.get_mesh() is None and tp.get_rules() == tp.default_rules(None)
    with use_mesh(outer, {"kv": "model"}):
        assert tp.get_mesh() is outer and tp.get_rules()["kv"] == "model"
        with use_mesh(inner):
            assert tp.get_mesh() is inner
            assert tp.get_rules()["batch"] == ("pod", "data") and tp.get_rules()["kv"] is None
        assert tp.get_mesh() is outer and tp.get_rules()["kv"] == "model"
        assert tp.get_rules()["batch"] == ("data",) and tuple(tp.spec("batch")) == ("data",)
    assert tp.get_mesh() is None and tp.get_rules() == tp.default_rules(None)
    set_mesh(outer)
    try:
        assert tp.get_mesh() is outer
    finally:
        set_mesh(None)


def test_shard_is_a_no_op_without_a_mesh_or_a_dtensor():
    x = torch.randn(4, 8, 16)
    assert shard(x, "batch", "seq", "embed") is x
    with use_mesh(_meshes("16x16")[0]):
        assert shard(x, "batch", "seq", "embed") is x   # a plain tensor stays plain
    assert tp.batch_local(lambda a, w: a * w["s"], x, {"s": 2.0}).equal(x * 2.0)


def test_host_mesh_and_shard_on_a_world_of_one():
    """``make_host_mesh(device="cpu")`` starts a gloo world of one (or joins
    the running one) and builds (1, 1) over ("data", "model"); ``shard``
    redistributes a DTensor to its logical axes' placements."""
    from torch.distributed.tensor import distribute_tensor

    mesh = tmesh.make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="model-parallel"):
        tmesh.make_host_mesh(model_parallel=3, device="cpu")
    x = distribute_tensor(torch.randn(4, 6, 8), mesh, (Replicate(), Replicate()))
    with use_mesh(mesh):
        y = shard(x, "batch", "seq", "vocab")
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert shard(y, "batch", "seq", "vocab") is y
        assert torch.equal(y.full_tensor(), x.full_tensor())


def test_distribute_on_a_world_of_one_keeps_plain_tensors():
    """On a mesh of one rank every shard is the whole tensor: ``distribute``
    returns a plain leaf as it is, and a DTensor leaf as its local tensor."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shardings as shl

    mesh = tmesh.make_host_mesh(device="cpu")
    w, d = torch.randn(4, 6), distribute_tensor(torch.randn(2, 3), mesh, (Shard(0), Shard(1)))
    shd = {"p": {"w": (Shard(0), Shard(1))}, "d": (Replicate(), Replicate())}
    out = shl.distribute({"p": {"w": w}, "d": d}, shd, mesh)
    assert out["p"]["w"] is w
    assert not tp.is_dtensor(out["d"]) and torch.equal(out["d"], d.full_tensor())


def test_restore_places_leaves_with_their_shardings(tmp_path):
    """``checkpoint.restore(..., shardings=)``: a plain target's leaves come
    back as DTensors with the given placements (on the active mesh), a
    DTensor target with those placements is filled in place."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.training import checkpoint as ck

    mesh = tmesh.make_host_mesh(device="cpu")
    saved = {"params": {"w": torch.randn(4, 6)}, "opt": {"step": torch.tensor(3)}}
    ck.save(saved, str(tmp_path), step=3)
    shd = {"params": {"w": (Shard(0), Shard(1))}, "opt": {"step": (Replicate(), Replicate())}}
    plain = {"params": {"w": torch.zeros(4, 6)}, "opt": {"step": torch.tensor(0)}}
    with use_mesh(mesh):
        out = ck.restore(str(tmp_path), plain, shardings=shd)
    assert out is plain and tuple(plain["params"]["w"].placements) == (Shard(0), Shard(1))
    assert torch.equal(plain["params"]["w"].full_tensor(), saved["params"]["w"])
    assert int(plain["opt"]["step"].full_tensor()) == 3
    target = {"params": {"w": distribute_tensor(torch.zeros(4, 6), mesh, shd["params"]["w"])},
              "opt": {"step": distribute_tensor(torch.tensor(0), mesh, shd["opt"]["step"])}}
    w = target["params"]["w"]
    ck.restore(str(tmp_path), target, shardings=shd)
    assert target["params"]["w"] is w and torch.equal(w.full_tensor(), saved["params"]["w"])


def test_decode_attention_refuses_dtensors():
    """K7 refuses a mix of plain tensors and DTensors; on a DTensor cache
    sharded over its sequence dim (the ``kv_seq`` rule) it runs on each
    rank's shard and merges the shards' partial softmaxes
    (``ops.sharded_decode_attention``; the cache is not gathered), and
    equals the plain call."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.kernels import ops

    mesh = tmesh.make_host_mesh(device="cpu")
    q = torch.randn(2, 4, 16)
    k, v = torch.randn(2, 32, 2, 16), torch.randn(2, 32, 2, 16)
    kv_len = torch.full((2,), 20, dtype=torch.int32)
    with use_mesh(mesh):
        kc, vc = (shard(distribute_tensor(x, mesh, (Replicate(), Replicate())),
                        "batch", "kv_seq", "kv", "head_dim") for x in (k, v))
        placed = tuple(kc.placements)
        assert Shard(1) in placed
        with pytest.raises(TypeError, match="all be DTensors"):
            ops.decode_attention(q, kc, vc, kv_len)
        qd = distribute_tensor(q, mesh, (Replicate(), Replicate()))
        got = ops.decode_attention(qd, kc, vc, kv_len)
        assert tuple(kc.placements) == placed                   # not gathered
        torch.testing.assert_close(got.full_tensor(), ops.decode_attention(q, k, v, kv_len),
                                   rtol=1e-6, atol=1e-6)
    assert ops.decode_attention(q, k, v, kv_len).shape == (2, 4, 16)


def test_active_mesh_is_seen_by_other_threads():
    """Autograd runs a CUDA backward (and a remat block's recompute) on its
    own threads: the active mesh and rules are process-wide, so the
    recompute shards as the forward did."""
    import threading

    from repro_torch.models import partitioning

    mesh = partitioning.AbstractMesh((2, 2), ("data", "model"))
    seen = []
    with use_mesh(mesh, {"kv": "model"}):
        t = threading.Thread(target=lambda: seen.append((partitioning.get_mesh(),
                                                         partitioning.spec("kv"))))
        t.start()
        t.join()
    assert seen == [(mesh, partitioning.P("model"))]
    assert partitioning.get_mesh() is None
