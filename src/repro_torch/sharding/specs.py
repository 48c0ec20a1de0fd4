"""Partition-spec policies: map parameter / cache / batch trees to
per-dimension sharding specs for the production mesh, and specs to
DTensor placements.

Port of ``repro/sharding/specs.py``.  A spec is a plain tuple with one
entry per tensor dimension: ``None`` (replicated), a mesh axis name, or a
tuple of names (the dimension split over several axes, major to minor) —
the entries of the reference's ``PartitionSpec``.  ``mesh`` is a
``launch.mesh.MeshDesc`` or a ``DeviceMesh``: the rules read only its axis
names and sizes.

Baseline policy (paper-faithful Megatron-style TP + DP):
  * attention: q/o heads on "model"; k/v heads on "model" iff divisible,
    else replicated (GQA with kv < mesh);
  * MLP: d_ff on "model" (column/row parallel);
  * MoE: experts on "model" when cfg.expert_parallel and divisible (EP),
    else expert d_ff on "model" (tensor-parallel experts);
  * SSM: in/out projections sharded on the contracting d_model/d_inner dim;
  * embedding / LM head: vocab on "model";
  * FSDP (cfg.fsdp): parameters and optimizer state additionally sharded on
    "data" along the largest remaining dim (ZeRO-3);
  * batch: global batch on ("pod",) "data";
  * KV caches: batch on "data" + kv_shard_mode in {heads, sequence, batch}.

Every rule keys off parameter path names (``"layers/l0/mix/wq"``), which
the port's dict trees share with the reference's.  ``to_placements`` turns
a spec into ``Shard`` / ``Replicate`` placements over a ``DeviceMesh`` and
``distribute_tree`` places a whole tree; ``launch.dryrun.place_inputs``
places a step's arguments with them, and the step runs over the DTensors
under ``sharding.context.activation_sharding``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..configs.base import ArchConfig

Spec = Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``MeshDesc`` or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return dict(zip(names, tuple(mesh.shape)))


def _spec(*entries) -> Spec:
    """The entries as a ``PartitionSpec`` keeps them: a tuple of one axis
    is that axis's name, an empty tuple is None."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple)
                 and len(e) == 1 else e for e in entries)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and NamedTuples, the path
    joining keys and field names with "/"."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, k), join(k))
                            for k in tree._fields))
    return fn(prefix, tree)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _with_fsdp(spec: Tuple, shape: Tuple[int, ...], mesh,
               enabled: bool) -> Spec:
    """Add "data" sharding on the largest unsharded, divisible dim."""
    spec = list(spec)
    if enabled:
        dsize = _axis_size(mesh, "data")
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
                spec[i] = "data"
                break
    return tuple(spec)


def param_spec(cfg: ArchConfig, mesh, path: str,
               shape: Tuple[int, ...]) -> Spec:
    msize = _axis_size(mesh, "model")
    fsdp = cfg.fsdp
    nd = len(shape)

    if cfg.parallelism_mode == "pure_dp":
        # no tensor parallelism: the whole mesh is one DP domain; parameters
        # are ZeRO-3 sharded over ("data","model") on the largest divisible
        # dim (always, regardless of cfg.fsdp — replication would not fit).
        n = _axis_size(mesh, "data") * msize
        s = [None] * nd
        order = sorted(range(nd), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % n == 0 and shape[i] >= n:
                s[i] = ("data", "model")
                break
        else:
            for i in order:   # fall back to data-only sharding
                if shape[i] % _axis_size(mesh, "data") == 0:
                    s[i] = "data"
                    break
        return tuple(s)

    def base():
        return [None] * nd

    def div(dim: int) -> bool:
        # an input's sharding must divide its dimension exactly: every axis
        # assignment is guarded
        return shape[dim] % msize == 0

    # --- embedding / lm head -------------------------------------------------
    if path.endswith("embed/table"):
        return ("model", "data" if fsdp and cfg.d_model % _axis_size(
            mesh, "data") == 0 else None)
    if path.endswith("lm_head/w"):
        return (None, "model") if not fsdp else ("data", "model")

    # --- attention ------------------------------------------------------------
    if "/mix/" in path and path.endswith(("wq",)):
        s = base()
        if div(-2):
            s[-2] = "model"                  # [.., d, H, hd]: heads
        elif div(-3):
            s[-3] = "model"                  # fallback: row-parallel on d
        return _with_fsdp(tuple(s), shape, mesh, fsdp)
    if "/mix/" in path and path.endswith(("wk", "wv")):
        s = base()
        if cfg.n_kv_heads % msize == 0 and div(-2):
            s[-2] = "model"
        elif div(-3):
            s[-3] = "model"                  # row-parallel on d
        return _with_fsdp(tuple(s), shape, mesh, fsdp)
    if "/mix/" in path and path.endswith("wo"):
        s = base()
        if div(-3):
            s[-3] = "model"                  # [.., H, hd, d]: heads
        elif div(-1):
            s[-1] = "model"                  # fallback: column-parallel on d
        return _with_fsdp(tuple(s), shape, mesh, fsdp)

    # --- MoE -------------------------------------------------------------------
    if path.endswith("router"):
        return tuple(base())
    if "/mlp/" in path and ("w_gate" in path or "w_up" in path
                            or "w_down" in path):
        is_expert = nd >= 3 and cfg.n_experts > 0 and \
            shape[-3] == cfg.n_experts if nd >= 3 else False
        if is_expert:
            s = base()
            if cfg.expert_parallel and cfg.n_experts % msize == 0:
                s[-3] = "model"              # EP: experts across model axis
            else:
                # TP experts: shard d_ff
                ff_dim = -1 if "w_gate" in path or "w_up" in path else -2
                s[ff_dim] = "model"
            return _with_fsdp(tuple(s), shape, mesh, fsdp)
        # dense MLP (or arctic dense residual)
        s = base()
        s[-1 if ("w_gate" in path or "w_up" in path) else -2] = "model"
        return _with_fsdp(tuple(s), shape, mesh, fsdp)

    # --- SSM --------------------------------------------------------------------
    if path.endswith("in_proj"):
        s = base()
        s[-2] = "model"                      # contracting d_model dim
        return _with_fsdp(tuple(s), shape, mesh, fsdp)
    if path.endswith("out_proj"):
        s = base()
        s[-2] = "model"                      # contracting d_inner dim
        return _with_fsdp(tuple(s), shape, mesh, fsdp)
    if "conv_w" in path or "conv_b" in path:
        return tuple(base())

    # --- norms / scalars / exits -------------------------------------------------
    return tuple(base())


def params_shardings(cfg: ArchConfig, mesh, params_shapes):
    """A tree of specs matching a parameter (shape) tree."""
    return _map_with_path(
        lambda path, leaf: param_spec(cfg, mesh, path, tuple(leaf.shape)),
        params_shapes)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _dp_if_divisible(mesh, batch: int, *, all_axes: bool = False):
    names = _axis_names(mesh)
    dp = dp_axes(mesh) + (("model",) if all_axes and "model" in names
                          else ())
    n = 1
    for a in dp:
        n *= _axis_size(mesh, a)
    if n and batch % n == 0:
        return dp
    # try dropping the model axis, then give up
    dp = dp_axes(mesh)
    n = 1
    for a in dp:
        n *= _axis_size(mesh, a)
    return dp if (n and batch % n == 0) else None


def cache_spec(cfg: ArchConfig, mesh, path: str,
               shape: Tuple[int, ...]) -> Spec:
    msize = _axis_size(mesh, "model")
    pure = cfg.parallelism_mode == "pure_dp"
    if pure:
        msize = 1  # no model-axis sharding of heads/seq in pure DP
    if path.endswith(("/k", "/v")):
        # [n_periods, B, T, KV, hd]
        dp = _dp_if_divisible(mesh, shape[1], all_axes=pure)
        mode = cfg.kv_shard_mode
        if mode == "auto":
            mode = "heads" if cfg.n_kv_heads % msize == 0 else "sequence"
        if mode == "heads" and cfg.n_kv_heads % msize == 0:
            return _spec(None, dp, None, "model", None)
        if mode == "sequence" and shape[2] % msize == 0:
            return _spec(None, dp, "model", None, None)
        return _spec(None, dp, None, None, None)
    if path.endswith(("k_scale", "v_scale")):
        # [n_periods, B, T, KV] — mirror the k/v sharding sans head_dim
        dp = _dp_if_divisible(mesh, shape[1], all_axes=pure)
        mode = cfg.kv_shard_mode
        if mode == "auto":
            mode = "heads" if cfg.n_kv_heads % msize == 0 else "sequence"
        if msize > 1 and mode == "heads" and cfg.n_kv_heads % msize == 0:
            return _spec(None, dp, None, "model")
        if msize > 1 and mode == "sequence" and shape[2] % msize == 0:
            return _spec(None, dp, "model", None)
        return _spec(None, dp, None, None)
    if path.endswith("/pos"):
        return (None, None)
    if path.endswith("/state"):        # [n, B, H, P, N]
        dp = _dp_if_divisible(mesh, shape[1], all_axes=pure)
        s = [None, dp, None, None, None]
        if msize > 1 and cfg.ssm_head_shard and shape[2] % msize == 0:
            s[2] = "model"
        return _spec(*s)
    if path.endswith("/conv"):         # [n, B, w-1, C]
        dp = _dp_if_divisible(mesh, shape[1], all_axes=pure)
        return _spec(None, dp, None, None)
    return (None,) * len(shape)


def caches_shardings(cfg: ArchConfig, mesh, cache_shapes):
    return _map_with_path(
        lambda path, leaf: cache_spec(cfg, mesh, path, tuple(leaf.shape)),
        cache_shapes)


# ---------------------------------------------------------------------------
# Batch / activations
# ---------------------------------------------------------------------------

def batch_shardings(cfg: ArchConfig, mesh, batch_shapes):
    pure = cfg.parallelism_mode == "pure_dp"

    def fn(path, leaf):
        spec = [None] * leaf.dim()
        spec[0] = _dp_if_divisible(mesh, leaf.shape[0], all_axes=pure)
        return _spec(*spec)
    return _map_with_path(fn, batch_shapes)


def scalar_sharding(mesh) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def shard_count(spec: Spec, mesh) -> int:
    """How many pieces a tensor with ``spec`` is cut into on ``mesh``."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in _entry_axes(entry):
            n *= sizes[a]
    return n


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> list:
    """``Shard(dim)`` / ``Replicate()`` for each dimension of ``mesh`` (a
    ``DeviceMesh``).  A tensor dimension split over several mesh axes
    shards in the spec's major-to-minor order, which must be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = []
        for a in _entry_axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                                 f"the mesh's {names}")
            i = names.index(a)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            idx.append(i)
            placements[i] = Shard(dim)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {dim} splits over "
                             f"{entry} against the mesh's order {names}")
    return placements


def distribute_tree(tree, specs, device_mesh):
    """Every tensor of ``tree`` as a ``DTensor`` on ``device_mesh``, placed
    by the spec at the same place of ``specs`` (a tree of the same
    structure, e.g. from ``params_shardings``)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], device_mesh)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(getattr(tree, k),
                                            getattr(specs, k), device_mesh)
                            for k in tree._fields))
    return distribute_tensor(tree, device_mesh,
                             to_placements(specs, device_mesh))
