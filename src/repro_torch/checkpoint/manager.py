"""Checkpointing with content-addressed chunks — the substrate the paper's
technique synchronizes.

Port of ``repro/checkpoint/manager.py`` over torch pytrees (nested dicts,
lists and tuples of tensors, or a flat ``state_dict``).  A checkpoint is
stored as fixed-size chunks keyed by (leaf path, chunk idx) plus a
manifest of keyed digests:

* **Elastic restore** — chunks are addressed by logical position, not by
  device, so a checkpoint written from any device restores onto any other.
* **Reconciliation-ready** — the manifest is a *set* of fixed-length records
  (key-hash ‖ chunk-digest), exactly the shape Rateless IBLT reconciles;
  :mod:`repro_torch.checkpoint.reconcile` repairs a stale/corrupt store by
  streaming coded symbols from a peer instead of re-downloading everything.

The on-disk format is the reference's byte for byte: ``manifest.json`` and
``chunks/<leaf>#<idx>.bin``, leaf names joined from the dict keys and list
indices of the path, dtypes under their numpy names (``"bfloat16"``
included), leaves in the order ``jax.tree_util`` flattens them (plain
dicts by sorted key; torch's pytree keeps insertion order, so ``save``
sorts first).  A store written by either package is read, verified and
repaired by the other.
"""
from __future__ import annotations

import collections
import hashlib
import json
import math
import os

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.decoder import resolve_device
from repro_torch.core.hashing import siphash24

CHUNK_BYTES = 1 << 18  # 256 KiB

# the numpy dtype names a manifest records, and the torch dtypes they name
_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "bool")}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def _leaf_name(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _leaf_paths(tree):
    flat, spec = pytree.tree_flatten_with_path(tree)
    return [(_leaf_name(path), leaf) for path, leaf in flat], spec


def _in_jax_order(tree):
    """``tree`` with every dict but an OrderedDict rebuilt in sorted key
    order, so that torch's pytree flattens it as ``jax.tree_util`` does."""
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict(
            (k, _in_jax_order(v)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _in_jax_order(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_in_jax_order(v) for v in tree)
    return tree


def _host_bytes(leaf) -> tuple[np.ndarray, str]:
    """A tensor leaf's raw bytes on the host (one leaf copied at a time)
    and its dtype's numpy name."""
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"checkpoint leaves must be tensors, got "
                        f"{type(leaf).__name__}")
    if leaf.dtype not in _NAMES:
        raise TypeError(f"dtype {leaf.dtype} has no numpy name here")
    flat = leaf.detach().contiguous().cpu().reshape(-1)
    return flat.view(torch.uint8).numpy(), _NAMES[leaf.dtype]


def _chunks_of(raw: np.ndarray):
    for i in range(0, max(len(raw), 1), CHUNK_BYTES):
        yield i // CHUNK_BYTES, raw[i:i + CHUNK_BYTES]


def _digest(key_name: str, idx: int, data) -> int:
    """Keyed blake2b of one chunk (bytes or a contiguous uint8 array)."""
    h = hashlib.blake2b(data, digest_size=8,
                        key=(key_name + f"#{idx}").encode()[:64])
    return int.from_bytes(h.digest(), "little")


def cid_hashes(cids) -> np.ndarray:
    """(n,) uint64 keyed SipHash of each chunk id, zero-padded (or cut) to
    64 bytes — the key-hash half of a manifest record."""
    if not cids:
        return np.zeros(0, np.uint64)
    raw = b"".join(cid.encode().ljust(64, b"\0")[:64] for cid in cids)
    return siphash24(np.frombuffer(raw, np.uint32).reshape(len(cids), 16))


def tree_from_numpy(tree, device="cuda"):
    """A pytree of numpy arrays as the port's tensors on ``device``.

    A ``bfloat16`` array (dtype named so, e.g. by ``ml_dtypes``) goes over
    as its raw 16-bit words, reinterpreted as ``torch.bfloat16``."""
    device = resolve_device(device)

    def leaf(arr):
        arr = np.array(arr, order="C")
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)

    return pytree.tree_map(leaf, tree)


class CheckpointStore:
    """Directory layout: manifest.json + chunks/<leafname>#<idx>.bin."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)

    # -- write -------------------------------------------------------------
    def save(self, step: int, tree) -> dict:
        """Write every tensor leaf of ``tree`` (on any device) as chunks
        and the manifest; returns the manifest."""
        leaves, _ = _leaf_paths(_in_jax_order(tree))
        manifest = {"step": step, "chunks": {}, "leaves": {}}
        for name, leaf in leaves:
            raw, dtype = _host_bytes(leaf)
            manifest["leaves"][name] = {"shape": list(leaf.shape),
                                        "dtype": dtype}
            for idx, data in _chunks_of(raw):
                cid = f"{name}#{idx}"
                manifest["chunks"][cid] = _digest(name, idx, data)
                with open(self._chunk_path(cid), "wb") as f:
                    f.write(data)
        with open(os.path.join(self.root, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        return manifest

    def _chunk_path(self, cid: str) -> str:
        return os.path.join(self.root, "chunks",
                            cid.replace("/", "_") + ".bin")

    # -- read ---------------------------------------------------------------
    def manifest(self) -> dict | None:
        path = os.path.join(self.root, "manifest.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def load_leaf(self, name: str, info: dict) -> torch.Tensor:
        """One leaf as a CPU tensor of its manifest shape and dtype."""
        dtype = _DTYPES[info["dtype"]]
        nbytes = math.prod(info["shape"]) * dtype.itemsize
        raw = torch.empty(nbytes, dtype=torch.uint8)
        buf = memoryview(raw.numpy())
        pos, idx = 0, 0
        while pos < nbytes:
            with open(self._chunk_path(f"{name}#{idx}"), "rb") as f:
                pos += f.readinto(buf[pos:])
            idx += 1
        return raw.view(dtype).reshape(info["shape"])

    def restore(self, tree_struct, device="cuda"):
        """Restore into any pytree of tensors (meta tensors will do) whose
        leaf names, shapes and dtypes the manifest holds; returns the same
        structure of tensors on ``device``.  Elastic: chunks are logically
        addressed, so where the checkpoint was written is irrelevant."""
        device = resolve_device(device)
        man = self.manifest()
        if man is None:
            raise FileNotFoundError(f"no checkpoint present in {self.root}")
        leaves, spec = _leaf_paths(tree_struct)
        out = []
        for name, leaf in leaves:
            info = man["leaves"][name]
            if list(leaf.shape) != info["shape"] or \
                    _NAMES.get(leaf.dtype) != info["dtype"]:
                raise ValueError(
                    f"{name}: asked for {list(leaf.shape)} "
                    f"{leaf.dtype}, the checkpoint holds {info}")
            out.append(self.load_leaf(name, info).to(device))
        return pytree.tree_unflatten(out, spec)

    def verify(self) -> list[str]:
        """Return chunk ids whose on-disk bytes mismatch the manifest
        (detects corruption / torn writes after a crash)."""
        man = self.manifest()
        bad = []
        for cid, dig in man["chunks"].items():
            name, idx = cid.rsplit("#", 1)
            try:
                with open(self._chunk_path(cid), "rb") as f:
                    data = f.read()
                if _digest(name, int(idx), data) != dig:
                    bad.append(cid)
            except FileNotFoundError:
                bad.append(cid)
        return bad

    # -- reconciliation records ---------------------------------------------
    def records(self) -> np.ndarray:
        """Manifest as fixed-length set items: 8B key-hash ‖ 8B digest,
        little-endian, in sorted chunk-id order — the set Rateless IBLT
        reconciles.  (n, 16) uint8."""
        chunks = sorted(self.manifest()["chunks"].items())
        recs = np.zeros((len(chunks), 2), "<u8")
        recs[:, 0] = cid_hashes([cid for cid, _ in chunks])
        recs[:, 1] = np.array([dig & (2**64 - 1) for _, dig in chunks],
                              np.uint64)
        return recs.view(np.uint8).reshape(-1, 16)
