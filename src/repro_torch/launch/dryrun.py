"""Multi-pod dry run: one step of every (arch × shape) cell on the
production meshes, without a device and without allocating.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell on 256/512 forced host devices and reads the compiled
artifact.  Torch has no such compiler, so a cell here runs for real on
an abstract machine: a fake process group of 256 (``--mesh pod``) or 512
(``multipod``) ranks, the production mesh over it
(:func:`.mesh.make_production_mesh`), and ``FakeTensorMode``, in which
every tensor has a shape and a dtype and no storage.  The parameters are
drawn by the model's own ``init`` and placed by its specs (the
counterpart of ``abstract_init``), and one train step, prefill or decode
step runs through the same code as on the card (DTensor propagation,
``local_map`` regions, collectives); a dispatch mode sees each rank-local
op and collective.

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \
        --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh multipod] [--jobs N]

Results land in ``out/dryrun_torch/<arch>__<shape>__<mesh>.json`` (cached;
``--force`` re-runs).  ``--all`` runs one subprocess a cell (a process
holds one default process group, and a pathological cell cannot poison
the rest), ``--jobs`` of them at once.  Fields:

* ``devices``, ``trace_s`` (seconds of the step under the fake mode);
* ``memory.argument_size_in_bytes``: one rank's blocks of the
  parameters, optimizer state and batch (or caches), exact from the local
  shapes; ``memory.output_size_in_bytes``: of what the step returns;
  ``temp_size_in_bytes`` null (no compiler reports it);
* ``flops_per_device``: the FLOPs of one rank's local ops (matmuls,
  attention; torch's ``flop_counter`` formulas on the local shapes;
  causal attention counted whole, as those formulas do);
  ``bytes_per_device`` null;
* ``collectives``: per kind of the reference's five (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the count of the ``c10d_functional``
  collectives one rank issues and the bytes of their operands (the
  tensor the rank contributes).  The reference's ``parse_collectives``
  reads HLO text, which torch does not produce; it has no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "out",
                       "dryrun_torch")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d_functional op name -> the reference's kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


def _nbytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _flop_formulas() -> dict:
    """torch's formulas by op packet (called with shapes), plus the CPU
    flash attention's, which ``flop_counter`` does not list: its two
    matmuls forward (4·b·h·s·t·d) and four backward, the query's h heads
    (grouped K/V heads are read, not multiplied, once a query head)."""
    import torch
    from torch.utils import flop_counter as fc
    out = dict(fc.flop_registry)
    aten = torch.ops.aten

    def fwd(q, k, v, *args, out_val=None, **kwargs):
        b, h, s, d = q
        return 4 * b * h * s * k[-2] * d

    def bwd(grad, q, k, v, *args, out_val=None, **kwargs):
        b, h, s, d = q
        return 8 * b * h * s * k[-2] * d

    for name, fn in (("_scaled_dot_product_flash_attention_for_cpu", fwd),
                     ("_scaled_dot_product_flash_attention_for_cpu_backward",
                      bwd)):
        if hasattr(aten, name):
            out[getattr(aten, name)] = fn
    return out


def collective_counter(keep_group=None):
    """A dispatch mode that sees each rank-local op under DTensor: it
    counts collectives by kind (count, operand bytes) and FLOPs; with
    ``keep_group`` (a group name) it keeps a copy of every all-gather's
    operand on that group (``.gathered``).  The mode returns
    ``NotImplemented`` for DTensor calls, so DTensor runs first and the
    local ops and collectives it issues come back through the mode.
    DTensor's sharding propagation also runs ops, on tensors of the
    global shapes, to infer its outputs' shapes; while the mode is on,
    those calls are marked and not counted."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map_only

    formulas = _flop_formulas()
    infer = ShardingPropagator._propagate_tensor_meta_non_cached

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.collectives = {k: {"count": 0, "bytes": 0}
                                for k in COLLECTIVES}
            self.flops = 0
            self.gathered = []
            self.inferring = 0

        def __enter__(self):
            def marked(prop, *args, **kwargs):
                self.inferring += 1
                try:
                    return infer(prop, *args, **kwargs)
                finally:
                    self.inferring -= 1
            ShardingPropagator._propagate_tensor_meta_non_cached = marked
            return super().__enter__()

        def __exit__(self, *exc):
            ShardingPropagator._propagate_tensor_meta_non_cached = infer
            return super().__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if isinstance(func, torch._ops.HigherOrderOperator) or \
                    self.inferring:
                return out
            pkt = func._overloadpacket
            ns, name = pkt._qualified_op_name.split("::")
            kind = _KINDS.get(name) if ns in (
                "_c10d_functional", "_c10d_functional_autograd") else None
            if kind is not None:
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += _nbytes(args[0])
                if kind == "all-gather" and keep_group is not None and \
                        args[-1] == keep_group:
                    self.gathered.append(args[0].detach().clone())
            elif pkt in formulas:
                shapes = tree_map_only(torch.Tensor, lambda t: t.shape,
                                       (args, kwargs))
                self.flops += formulas[pkt](*shapes[0], **shapes[1],
                                            out_val=out)
            return out

    return Counter()


def init_fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks (this is rank 0);
    collectives on it return their inputs' shapes and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_inputs(metas, specs, mesh):
    """Meta tensors -> fake tensors of the same shapes, placed by their
    specs (zeros: token ids and positions in range)."""
    import torch
    from repro_torch.launch.mesh import distribute
    from torch.utils._pytree import tree_map
    return distribute(tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype),
                               metas), specs, mesh)


def build_cell(arch: str, shape_name: str, mesh):
    """(run, arguments): ``run()`` is the cell's step on the abstract
    machine (the caller holds ``FakeTensorMode``); ``arguments`` the
    tree of its inputs (parameters, optimizer state, batch or caches)."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.mesh import distribute
    from repro_torch.models import build_model, input_specs
    from repro_torch.train.loop import make_opt_config, make_train_step
    from repro_torch.train.optim import init_state

    cfg, shape = get_config(arch), get_shape(shape_name)
    model = build_model(cfg, mesh, device="cpu")
    params, specs = model.init(torch.Generator())
    params = distribute(params, specs, mesh)
    metas, pspecs = input_specs(cfg, shape, mesh)
    inputs = _fake_inputs(metas, pspecs, mesh)
    if shape.kind == "train":
        opt_cfg = make_opt_config(cfg)
        state = init_state(opt_cfg, params)
        step = make_train_step(model, opt_cfg, microbatches=cfg.microbatches)
        return (lambda: step(params, state, inputs)), \
            {"params": params, "opt": state, "batch": inputs}
    if shape.kind == "prefill":
        def run():
            with torch.no_grad():
                return model.prefill(params, inputs)
        return run, {"params": params, "batch": inputs}

    def run():
        with torch.no_grad():
            return model.decode_step(params, inputs["tokens"],
                                     inputs["caches"], inputs["pos"])
    return run, {"params": params, "batch": inputs}


def run_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    """One cell in this process (which must hold no process group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import local_bytes, make_production_mesh
    multi_pod = mesh_name == "multipod"
    init_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    with FakeTensorMode():
        run, arguments = build_cell(arch, shape_name, mesh)
        init_s = time.time() - t0
        counter = collective_counter()
        t0 = time.time()
        with counter:
            outputs = run()
        trace_s = time.time() - t0
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "devices": mesh.size(), "init_s": round(init_s, 1),
        "trace_s": round(trace_s, 1),
        "flops_per_device": float(counter.flops),
        "bytes_per_device": None,
        "memory": {"argument_size_in_bytes": local_bytes(arguments),
                   "output_size_in_bytes": local_bytes(outputs),
                   "temp_size_in_bytes": None},
        "collectives": counter.collectives,
    }
    print(json.dumps({k: v for k, v in result.items()
                      if k != "collectives"}), flush=True)
    print("collectives:", json.dumps(counter.collectives), flush=True)
    return result


def cell_path(arch, shape, mesh_name, out_dir=OUT_DIR):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")


def _run_all(todo, out_dir: str, jobs: int, timeout: int) -> list:
    """One subprocess a cell, ``jobs`` at a time, the train cells (the
    longest to trace) first; the failed cells."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", ".."))
    pending = sorted(todo, key=lambda cell: cell[1] != "train_4k")
    running, failures = [], []
    while pending or running:
        while pending and len(running) < jobs:
            a, s, m = pending.pop(0)
            print(f"[run] {a} {s} {m}", flush=True)
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 a, "--shape", s, "--mesh", m, "--out", out_dir], env=env,
                text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            running.append(((a, s, m), proc, time.time()))
        time.sleep(0.2)
        for item in list(running):
            cell, proc, t0 = item
            if proc.poll() is None and time.time() - t0 < timeout:
                continue
            if proc.poll() is None:
                proc.kill()
            out, err = proc.communicate()
            running.remove(item)
            if proc.returncode != 0:
                failures.append(cell)
                print(f"[FAIL] {' '.join(cell)}\n{out[-2000:]}\n"
                      f"{err[-2000:]}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR, help="directory of the JSON")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once in --all mode")
    ap.add_argument("--timeout", type=int, default=3000,
                    help="per-cell subprocess timeout (s) in --all mode")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        from repro_torch.configs import cells
        todo = []
        for a, s, _ in cells():
            if os.path.exists(cell_path(a, s, args.mesh, args.out)) and \
                    not args.force:
                print(f"[cached] {a} {s} {args.mesh}", flush=True)
            else:
                todo.append((a, s, args.mesh))
        failures = _run_all(todo, args.out, args.jobs, args.timeout)
        print(f"done; {len(failures)} failures: {failures}", flush=True)
        sys.exit(1 if failures else 0)

    result = run_cell(args.arch, args.shape, args.mesh)
    with open(cell_path(args.arch, args.shape, args.mesh, args.out),
              "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
