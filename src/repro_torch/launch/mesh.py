"""Device meshes, and the specs that place tensors on them.

Port of ``repro/launch/mesh.py``.  Single pod: (data=16, model=16), 256
ranks; multi-pod: (pod=2, data=16, model=16), 512 ranks, the "pod" axis
data-parallel.  A mesh is a torch ``DeviceMesh`` over the default process
group: the dry run (:mod:`.dryrun`) builds the production meshes over a
fake group of 256 or 512 ranks; :func:`make_local_mesh` builds one over
the real devices, starting a group itself if none is present.

A *spec* is the port's counterpart of the reference's ``PartitionSpec``:
a tuple with one entry per leading tensor dim (dims past its end are
replicated), each ``None``, a mesh axis name, or a tuple of axis names.
:func:`placements` turns it into DTensor placements and
:func:`distribute` turns a tree of tensors and a tree of specs into a tree
of ``DTensor``s, the counterpart of ``NamedSharding``.

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten


def is_spec(x) -> bool:
    """Specs are the tuples of a spec tree; its dicts and lists are
    nodes."""
    return isinstance(x, tuple)


def spec_axes(entry) -> tuple:
    """The mesh axis names of one spec entry, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that tensor dim i names, ``Replicate()`` on every other.
    An axis may appear once; a dim that names several axes names them in
    the mesh's order (the first the major one, as in the reference)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(dim)
    return out


def _check_divides(shape, spec, mesh) -> None:
    """Raise unless every sharded dim divides evenly over its axes (as
    ``jit``'s ``in_shardings`` would; DTensor would make uneven shards)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)} has dims")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for dim, entry in enumerate(spec):
        n = 1
        for a in spec_axes(entry):
            n *= sizes[a]
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} does not "
                             f"divide over {spec_axes(entry)} ({n} ranks)")


def _local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view)."""
    _check_divides(t.shape, spec, mesh)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements(spec, mesh)):
        if p.is_shard():
            n = mesh.size(i)
            step = t.shape[p.dim] // n
            t = t.narrow(p.dim, coord[i] * step, step)
    return t


def distribute_leaf(t: torch.Tensor, spec, mesh):
    """``t`` (the same full tensor on every rank) as a DTensor under
    ``spec``, built from this rank's block without communication; the
    block is copied when it is not the whole tensor, so the full tensor
    is freed with its last reference."""
    from torch.distributed.tensor import DTensor
    block = _local_slice(t, spec, mesh)
    if block.shape != t.shape:
        block = block.clone()
    return DTensor.from_local(block.detach(), mesh, placements(spec, mesh),
                              run_check=False).requires_grad_(
                                  t.requires_grad)


def distribute(tree, specs, mesh):
    """A tree of tensors -> the same tree of DTensors on ``mesh``, each
    leaf placed by its spec in ``specs`` (a tree of the same structure,
    dicts matched by key, with spec leaves).  Every rank must hold the
    same full tensors (drawn from one seed, or restored from one
    store)."""
    if is_spec(specs):
        return distribute_leaf(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"{len(tree)} subtrees but {len(specs)} specs")
        return type(tree)(distribute(v, s, mesh)
                          for v, s in zip(tree, specs))
    raise TypeError(f"no spec tuple for a {type(tree).__name__}")


def full_tree(tree):
    """A tree of DTensors (or plain tensors) -> plain full tensors, leaf
    by leaf (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten([t.full_tensor() if isinstance(t, DTensor) else t
                           for t in leaves], treedef)


def local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of DTensors (plain tensors count
    whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the default process group, which must
    have 256 (512 with ``multi_pod``) ranks: the dry run's fake group,
    whose ranks hold CPU tensors (fake ones: nothing is allocated)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("cpu", shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A (data, model) mesh over the real devices.  Without a process
    group it starts one of ``data * model`` = 1 rank (a ``HashStore``;
    NCCL on the card, gloo on the CPU; no environment variables); with
    one, ``data * model`` must be its size.  On the card each rank uses
    the card of its rank's index (``torch.cuda.set_device``)."""
    from repro_torch.core.decoder import resolve_device
    device = resolve_device(device)
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(f"no process group, so the mesh has one rank, "
                             f"not {data}x{model}")
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if data * model != dist.get_world_size():
        raise ValueError(f"a {data}x{model} mesh over "
                         f"{dist.get_world_size()} ranks")
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return _mesh(device.type, (data, model), ("data", "model"))
