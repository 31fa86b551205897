"""The port's mesh side (specs, ``state_specs``, the dry run) ≡ the JAX
package's, on the CPU.

Every model ``init`` of the port returns specs that equal the reference's
PartitionSpecs leaf for leaf (as tuples) at the production mesh, for each
config's full size; so do ``optim.state_specs`` for AdamW and Adafactor
with and without momentum, and ``input_specs``.  The reference's come from
``jax.eval_shape`` of its ``init`` on a stub mesh object with the
production mesh's ``axis_names`` and ``devices.shape`` (all its
``mesh_axes_of`` reads), the port's from its ``init`` under
``FakeTensorMode`` on a stub with the ``DeviceMesh`` attributes its
``mesh_axes_of`` reads: no allocation on either side.  The dry run's
per-rank argument bytes are held against the arithmetic of the
reference's specs and shapes (each leaf's bytes over the ranks its spec
shards it across), for one config a family at ``train_4k`` and for one
whole ``qwen3-4b decode_32k`` cell run under the fake process group; both
run in a subprocess (a process holds one default process group).
"""
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import input_specs as ref_input_specs  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = {"data": 16, "model": 16}
# one config a family: dense, MoE (Adafactor without momentum, bf16
# state), SSM, hybrid, encoder-decoder, VLM (Adafactor with momentum)
FAMILIES = ["qwen3-4b", "kimi-k2-1t-a32b", "rwkv6-1.6b",
            "recurrentgemma-2b", "whisper-base", "internvl2-76b"]


def ref_mesh():
    return types.SimpleNamespace(axis_names=tuple(POD),
                                 devices=np.empty(tuple(POD.values())))


def port_stub():
    return types.SimpleNamespace(mesh_dim_names=tuple(POD),
                                 shape=tuple(POD.values()))


def as_tuples(tree):
    """A reference spec tree with tuples for PartitionSpecs, lists for
    its sequences."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_tuples(v) for v in tree]
    return tree


def struct(tree):
    """A tree of arrays or tensors as nested dicts and lists of (shape,
    dtype name) leaves."""
    if isinstance(tree, dict):
        return {k: struct(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [struct(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@functools.lru_cache(maxsize=None)
def ref_init(arch):
    """(param ShapeDtypeStructs, specs) of the reference's full config,
    abstractly (its dry run's ``abstract_init``)."""
    model = ref_build_model(ref_configs.get_config(arch), ref_mesh())
    held = []

    def run(k):
        p, s = model.init(k)
        held.append(s)
        return p

    return jax.eval_shape(run, jax.random.key(0)), held[0]


@functools.lru_cache(maxsize=None)
def port_init(arch):
    with FakeTensorMode():
        params, specs = build_model(configs.get_config(arch), port_stub(),
                                    device="cpu").init(torch.Generator())
    return params, specs


def spec_bytes(shapes, specs, sizes=POD) -> int:
    """One rank's bytes of a tree of ShapeDtypeStructs under a tree of
    PartitionSpecs: each leaf's bytes over the ranks its spec shards it
    across."""
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for t, sp in zip(leaves, spec_leaves):
        n = 1
        for entry in sp:
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                n *= sizes[a]
        nbytes = int(np.prod(t.shape)) * jnp.dtype(t.dtype).itemsize
        assert nbytes % n == 0
        total += nbytes // n
    return total


def ref_train_bytes(arch) -> int:
    """The reference's arguments of a ``train_4k`` step on the pod mesh:
    parameters, optimizer state and batch."""
    cfg = ref_configs.get_config(arch)
    shapes, specs = ref_init(arch)
    opt_cfg = ref_loop.make_opt_config(cfg)
    o_shapes = jax.eval_shape(lambda p: ref_optim.init_state(opt_cfg, p),
                              shapes)
    b_shapes, b_specs = ref_input_specs(
        cfg, ref_configs.get_shape("train_4k"), ref_mesh())
    return (spec_bytes(shapes, specs) +
            spec_bytes(o_shapes, ref_optim.state_specs(opt_cfg, specs)) +
            spec_bytes(b_shapes, b_specs))


def run_python(code: str, timeout: int = 240) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_specs_match_reference(arch):
    """Every parameter's spec, shape and dtype at the production mesh."""
    shapes, specs = ref_init(arch)
    params, got = port_init(arch)
    assert got == as_tuples(specs)
    assert struct(params) == struct(shapes)


@pytest.mark.parametrize("kind,momentum", [("adamw", True),
                                           ("adafactor", True),
                                           ("adafactor", False)])
def test_state_specs_match_reference(kind, momentum):
    """``state_specs`` mirrors the parameters' specs as the reference's
    does (the factored ``vr``/``vc`` drop the last and second-to-last
    axes), over every leaf of kimi-k2's and recurrentgemma-2b's trees."""
    for arch in ("kimi-k2-1t-a32b", "recurrentgemma-2b"):
        _, specs = ref_init(arch)
        _, got = port_init(arch)
        want = ref_optim.state_specs(
            ref_optim.OptConfig(kind=kind, momentum=momentum), specs)
        assert optim.state_specs(optim.OptConfig(kind=kind,
                                                 momentum=momentum),
                                 got) == as_tuples(want)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_input_specs_match_reference(shape):
    """Every input of a cell, caches included: shapes, dtypes, specs."""
    for arch in FAMILIES:
        cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
        want, want_specs = ref_input_specs(ref_cfg, ref_configs.get_shape(
            shape), ref_mesh())
        got, got_specs = input_specs(cfg, configs.get_shape(shape),
                                     port_stub())
        assert got_specs == as_tuples(want_specs), arch
        assert struct(got) == struct(want), arch


def test_placements_and_divisibility():
    """A spec's placements (a dim over two axes shards on both, in mesh
    order); specs naming an axis twice or out of order, or not dividing
    their dim, raise."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 16, 16))
    assert port_mesh.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert port_mesh.placements((None,), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        port_mesh.placements(("model", "model"), mesh)
    with pytest.raises(ValueError):
        port_mesh.placements((("data", "pod"),), mesh)
    port_mesh._check_divides((64, 48), (("pod", "data"), "model"), mesh)
    with pytest.raises(ValueError):
        port_mesh._check_divides((64, 40), (None, "model"), mesh)
    with pytest.raises(ValueError):
        port_mesh._check_divides((48,), (("pod", "data"),), mesh)


def test_dryrun_train_argument_bytes_match_reference():
    """The dry run's per-rank argument bytes of a ``train_4k`` step on the
    pod mesh, one config a family, against the reference's arithmetic."""
    out = run_python(
        "import json, torch\n"
        "from torch._subclasses.fake_tensor import FakeTensorMode\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import local_bytes, "
        "make_production_mesh\n"
        "dryrun.init_fake_group(256)\n"
        "mesh = make_production_mesh()\n"
        "out = {}\n"
        f"for arch in {FAMILIES!r}:\n"
        "    with FakeTensorMode():\n"
        "        _, args = dryrun.build_cell(arch, 'train_4k', mesh)\n"
        "        out[arch] = local_bytes(args)\n"
        "print(json.dumps(out))\n")
    got = json.loads(out.strip().splitlines()[-1])
    assert got == {arch: ref_train_bytes(arch) for arch in FAMILIES}


def test_dryrun_decode_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch qwen3-4b --shape
    decode_32k --mesh pod`` under the fake group of 256 ranks writes the
    cell's JSON: the reference's argument bytes (parameters, tokens,
    positions, KV caches with the head dim over "model"), every
    collective kind, the EP-free cell's all-to-all count 0, FLOPs,
    nulls where no compiler reports."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "decode_32k", "--mesh", "pod", "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    cell = json.loads((tmp_path / "qwen3-4b__decode_32k__pod.json")
                      .read_text())
    shapes, specs = ref_init("qwen3-4b")
    b_shapes, b_specs = ref_input_specs(
        ref_configs.get_config("qwen3-4b"),
        ref_configs.get_shape("decode_32k"), ref_mesh())
    assert cell["devices"] == 256
    assert cell["memory"]["argument_size_in_bytes"] == \
        spec_bytes(shapes, specs) + spec_bytes(b_shapes, b_specs)
    assert cell["memory"]["temp_size_in_bytes"] is None
    assert cell["bytes_per_device"] is None
    assert cell["flops_per_device"] > 0
    assert set(cell["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert cell["collectives"]["all-to-all"]["count"] == 0
    # the per-token score partials summed over "model" in every layer
    assert cell["collectives"]["all-reduce"]["count"] >= 36
