"""The port's sharding specs, context and DTensor placements against the
reference's.

* Spec parity: for every parameter and cache leaf of the ten
  architectures, baseline and optimized, on the meshes (2, 4), (16, 16)
  and (2, 16, 16), ``tuple(reference PartitionSpec) == port spec``; the
  batch rule likewise.  The reference's ``param_spec`` / ``cache_spec`` /
  ``batch_shardings`` read only ``mesh.axis_names`` and
  ``mesh.devices.shape``, so a stand-in mesh object computes them in
  this process, with no 8-device subprocess (``batch_shardings`` with its
  ``NamedSharding`` constructor replaced by the spec it wraps).  The
  leaves are the port's meta trees, whose paths and shapes
  ``tests/test_torch_shapes.py`` holds to the reference's.
* ``activation_sharding`` / ``current`` give the reference's context.
* ``to_placements`` maps entries to ``Shard`` / ``Replicate``, and refuses
  an unknown axis, an axis used twice and a split against the mesh order.
* Placements: ``distribute_tree`` on a (2, 2) ("data", "model")
  ``DeviceMesh`` over 4 gloo CPU ranks, with the specs of the reduced
  qwen3-4b under the tensor-parallel + FSDP and the pure-DP policies:
  each rank's ``to_local()`` is the slice the spec names, and
  ``full_tensor()`` gives the tensor back.  Run as a script (``python
  tests/test_torch_specs.py <rank> <world> <port>``) this file is one
  rank.
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _expected_local(full, spec, coords, sizes, names):
    """The block of ``full`` that mesh coordinates ``coords`` hold under
    ``spec`` (each entry's axes major to minor)."""
    index = []
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, i = 1, 0
        for a in axes:
            k = names.index(a)
            i = i * sizes[k] + coords[k]
            n *= sizes[k]
        assert full.shape[dim] % n == 0, (spec, full.shape)
        step = full.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return full[tuple(index)]


def _worker(rank, world, port):
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import distribute_tree, params_shardings
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        dm = device_mesh(make_test_mesh((2, 2)), "cpu")
        coords = dm.get_coordinate()
        names, sizes = tuple(dm.mesh_dim_names), tuple(dm.shape)
        base = get("qwen3-4b", reduced=True)
        n_sharded = 0
        for tag, cfg in (("tp_fsdp", dataclasses.replace(base, fsdp=True)),
                         ("pure_dp", get("qwen3-4b", reduced=True,
                                         optimized=True))):
            params = TT.init_model(cfg, seed=0, device="cpu")
            specs = params_shardings(cfg, dm, params)
            dt = distribute_tree(params, specs, dm)
            full, spec, got = _flat(params), _flat(specs), _flat(dt)
            for path, x in full.items():
                want = _expected_local(x, spec[path], coords, sizes, names)
                local = got[path].to_local()
                assert torch.equal(local, want), (tag, path, spec[path])
                assert torch.equal(got[path].full_tensor(), x), (tag, path)
                n_sharded += any(e is not None for e in spec[path])
            print(f"rank {rank}: {tag} {len(full)} leaves exact", flush=True)
        assert n_sharded > 10
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


import repro.configs as RC                                    # noqa: E402
from repro.sharding import context as RCTX                    # noqa: E402
from repro.sharding import specs as RS                        # noqa: E402

import repro_torch.configs as PC                              # noqa: E402
from repro_torch.launch.mesh import (MeshDesc, device_mesh,   # noqa: E402
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import transformer as TT              # noqa: E402
from repro_torch.runtime import steps as PS                   # noqa: E402
from repro_torch.sharding import context as CTX               # noqa: E402
from repro_torch.sharding import specs as S                   # noqa: E402


class StandInMesh:
    """What the reference's spec rules read of a jax ``Mesh``."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _meshes(name):
    names, shape = MESHES[name]
    return StandInMesh(names, shape), MeshDesc(names, shape)


def _cfgs(arch, optimized):
    return (RC.get(arch, optimized=optimized),
            PC.get(arch, optimized=optimized))


def _ref_spec(sharding_or_spec):
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    return tuple(spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", list(PC.ARCH_NAMES))
def test_param_specs_equal_the_reference(arch, optimized, mesh):
    ref_cfg, cfg = _cfgs(arch, optimized)
    ref_mesh, port_mesh = _meshes(mesh)
    shapes = PS.params_shapes(cfg)
    got = _flat(S.params_shardings(cfg, port_mesh, shapes))
    leaves = _flat(shapes)
    assert sorted(got) == sorted(leaves)
    for path, leaf in leaves.items():
        want = _ref_spec(RS.param_spec(ref_cfg, ref_mesh, path,
                                       tuple(leaf.shape)))
        assert got[path] == want, (path, got[path], want)
        assert S.param_spec(cfg, port_mesh, path, tuple(leaf.shape)) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", [a for a in PC.ARCH_NAMES
                                  if PC.get(a).has_decoder])
def test_cache_specs_equal_the_reference(arch, optimized, mesh):
    """At the decode cells' batches and lengths and at a batch no data
    axis divides."""
    ref_cfg, cfg = _cfgs(arch, optimized)
    ref_mesh, port_mesh = _meshes(mesh)
    for B, T in ((128, 32_768), (1, 524_288), (3, 100), (256, 4096)):
        shapes = TT.cache_shape_dtypes(cfg, B, T)
        got = _flat(S.caches_shardings(cfg, port_mesh, shapes))
        for path, leaf in _flat(shapes).items():
            want = _ref_spec(RS.cache_spec(ref_cfg, ref_mesh, path,
                                           tuple(leaf.shape)))
            assert got[path] == want, (B, T, path, got[path], want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", list(PC.ARCH_NAMES))
def test_batch_specs_equal_the_reference(arch, optimized, mesh,
                                        monkeypatch):
    """The reference's ``batch_shardings`` with its ``NamedSharding``
    replaced by the spec it is given (a stand-in mesh builds none)."""
    import jax
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)
    ref_cfg, cfg = _cfgs(arch, optimized)
    ref_mesh, port_mesh = _meshes(mesh)
    for B in (256, 32, 128, 1, 3, 512):
        shapes = PS.batch_specs(cfg, B, 16)
        got = S.batch_shardings(cfg, port_mesh, shapes)
        want = RS.batch_shardings(ref_cfg, ref_mesh, {
            k: jax.ShapeDtypeStruct(tuple(v.shape), "int32")
            for k, v in shapes.items()})
        assert {k: _ref_spec(v) for k, v in want.items()} == got, B
    for B in (128, 1, 6):
        dp = S._dp_if_divisible(port_mesh, B)
        assert dp == RS._dp_if_divisible(ref_mesh, B)
        assert S._dp_if_divisible(port_mesh, B, all_axes=True) == \
            RS._dp_if_divisible(ref_mesh, B, all_axes=True)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_axes_and_scalar_equal_the_reference(mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    assert S.dp_axes(port_mesh) == RS.dp_axes(ref_mesh)
    assert S.scalar_sharding(port_mesh) == ()
    assert S.axis_sizes(port_mesh) == dict(zip(*MESHES[mesh]))


def test_production_meshes():
    assert make_production_mesh() == MeshDesc(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshDesc(
        ("pod", "data", "model"), (2, 16, 16))
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_test_mesh().shape == (2, 4)
    with pytest.raises(ValueError):
        MeshDesc(("data",), (2, 2))


# ---------------------------------------------------------------------------
# the sharding context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES) + ["data_only"])
def test_activation_sharding_equals_the_reference(mesh):
    if mesh == "data_only":
        ref_mesh, port_mesh = (StandInMesh(("data",), (8,)),
                               MeshDesc(("data",), (8,)))
    else:
        ref_mesh, port_mesh = _meshes(mesh)
    assert CTX.current() is None
    with CTX.activation_sharding(port_mesh) as got, \
            RCTX.activation_sharding(ref_mesh) as want:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert CTX.current() == got
        seen = []
        t = threading.Thread(target=lambda: seen.append(CTX.current()))
        t.start()
        t.join()
        assert seen == [None]           # thread-local
        inner = MeshDesc(("data", "model"), (2, 2))
        with CTX.activation_sharding(inner) as ctx2:
            assert CTX.current() == ctx2 and ctx2.model_size == 2
        assert CTX.current() == got
    assert CTX.current() is None


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def test_to_placements_maps_entries():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshDesc(("pod", "data", "model"), (2, 2, 2))
    assert S.to_placements((None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert S.to_placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert S.to_placements((("data", "model"),), mesh) == [
        Replicate(), Shard(0), Shard(0)]
    assert S.to_placements((), mesh) == [Replicate()] * 3
    assert S.shard_count((("pod", "data"), None, "model"), mesh) == 8
    with pytest.raises(ValueError, match="not one of"):
        S.to_placements(("expert",), mesh)
    with pytest.raises(ValueError, match="twice"):
        S.to_placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="order"):
        S.to_placements((("model", "data"),), mesh)


def test_device_mesh_needs_a_process_group_of_its_size():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(make_test_mesh((2, 2)), "cpu")


def test_four_gloo_ranks_hold_the_spec_slices():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "4",
                               str(port)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, out) in enumerate(outs):
        tail = "\n".join(out.splitlines()[-20:])
        assert rc == 0, f"rank {r} failed:\n{tail}"
        assert f"rank {r}: tp_fsdp" in out and "leaves exact" in out
        assert f"rank {r}: pure_dp" in out
