"""The port's mesh path on real ranks, on the CPU.

One gloo spawn of four ranks, a (2, 2) mesh over ("data", "model")
(``init_method`` a file under the test's temporary directory, so that
xdist workers never share a port).  For a smoke config of each family
(the MoE in both dispatch modes), every rank draws the same parameters
and batch; the loss, every gradient and one AdamW step on the mesh
(DTensors placed by the specs, EP's ``all_to_all_single`` on the model
group, gradients reduced over "data" by placement) equal the
single-device port's within rtol = atol = 1e-5 (fp32).

What "the single-device port's" means follows the reference's semantics
on a mesh: an EP MoE routes each data shard's tokens on their own (its
capacity counts that shard's tokens) and averages the shards' aux
losses, so its expectation is the single-device port run on each data
shard's rows, the cross entropy weighted by each shard's unmasked
labels, the aux losses averaged and the dropped pairs summed call by
call.  Every other family's is one call on the whole batch.

Each rank also records every all-gather on the model group: none of
them is a model-sharded weight's block (or its transpose) gathered
whole.  The store written from the mesh (``launch.train.save_state``:
each leaf's full tensor) is byte-identical to the one written from the
same state on one device.

In the same spawn, two ``make_train_step`` steps of the dense family
with two microbatches, without and with int8 error feedback (a
data-sharded batch sliced, the error buffer kept on DTensor gradients),
and a prefill and one decode step of the dense and the encoder-decoder
family (the KV caches' head dim split over the two model ranks, so the
decode sums its score partials over the model group), equal the
single-device port's within the same tolerance (error feedback: but for
the elements whose int8 rounding flips, see :func:`_train_step_gaps`).

Then, in this process, the port on the (1, 1) ``make_local_mesh()`` (a
one-rank gloo group it starts itself) is held against the reference on
its own ``make_local_mesh()``: the MoE's loss, prefill and one decode
step on the reference's parameters.
"""
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.utils._pytree import (tree_flatten, tree_map,  # noqa: E402
                                tree_unflatten)

from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_local_mesh as ref_local_mesh  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.launch.dryrun import collective_counter  # noqa: E402
from repro_torch.launch.mesh import (distribute, full_tree,  # noqa: E402
                                     make_local_mesh)
from repro_torch.launch.train import save_state  # noqa: E402
from repro_torch.models import (batch_specs, build_model,  # noqa: E402
                                params_from_numpy)
from repro_torch.train.compression import ErrorFeedbackInt8  # noqa: E402
from repro_torch.train.loop import (loss_and_grads,  # noqa: E402
                                    make_opt_config, make_train_step)
from repro_torch.train.optim import apply_updates, init_state  # noqa: E402

from _torch_model_cases import EXTRA, pad_caches, to_numpy  # noqa: E402

CASES = [("qwen3-4b", {}), ("qwen3-moe-30b-a3b", {}),
         ("qwen3-moe-30b-a3b", {"moe_mode": "tp"}), ("rwkv6-1.6b", {}),
         ("recurrentgemma-2b", {}), ("whisper-base", {}),
         ("internvl2-76b", {})]
B, S, DATA = 4, 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_ARCH = "qwen3-4b"
DECODE_ARCHS = ["qwen3-4b", "whisper-base"]


def _name(arch, edit):
    return arch + "".join(f"-{v}" for v in edit.values())


def _batch(cfg):
    """The same numpy-drawn batch on every rank: tokens, labels (some
    masked) and the stub frontend's inputs."""
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
             "labels": rng.integers(-1, cfg.vocab, size=(B, S))}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _expected(cfg, model, params, batch):
    """(loss, aux, per-call dropped pairs, gradients) of the single-device
    port, as the mesh computes them (see the module docstring)."""
    leaves, spec = tree_flatten(params)
    for p in leaves:
        p.requires_grad_()
    if cfg.n_experts and cfg.moe_mode == "ep":
        rows = B // DATA
        shards = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                  for i in range(DATA)]
        n = [(b["labels"] >= 0).sum() for b in shards]
        loss, aux, drops = 0.0, 0.0, []
        for b, n_d in zip(shards, n):
            model.moe_drops = []
            _, m = model.loss(params, b)
            loss = loss + m["ce"] * n_d / sum(n) + 0.01 * m["aux"] / DATA
            aux = aux + m["aux"] / DATA
            drops.append([int(c) for c in model.moe_drops])
        drops = [sum(c) for c in zip(*drops)]
    else:
        loss, m = model.loss(params, batch)
        aux, drops = m["aux"], []
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss), float(aux), drops, [g.detach() for g in grads]


def _max_gap(got, want):
    """The largest |got - want| - tol·|want| over the pairs of tensors
    (<= 0 when all are within TOL)."""
    return max(float(((g.float() - w.float()).abs() - TOL["atol"]
                      - TOL["rtol"] * w.float().abs()).max())
               for g, w in zip(got, want))


def _weight_gathers(gathered, blocks) -> int:
    """How many of the model-group all-gathers' operands are a
    model-sharded weight's block, one layer of one, or a transpose."""
    candidates = []
    for blk in blocks:
        for w in ([blk] + list(blk.unbind(0)) if blk.dim() == 3 else [blk]):
            candidates += [w.float(), w.float().T] if w.dim() == 2 else \
                [w.float()]
    return sum(any(t.shape == c.shape and torch.equal(t.float(), c)
                   for c in candidates) for t in gathered)


def _step_runs(mesh, compression):
    """Two steps of ``make_train_step(microbatches=2, compression=...)``
    of STEP_ARCH's smoke config on one device, then on the mesh, from
    the same parameters and batch: for each, the steps' losses and grad
    norms, the parameters, the optimizer moments and the error buffer as
    lists of full tensors."""
    cfg = configs.smoke_config(STEP_ARCH)
    params, specs = build_model(cfg, None, "cpu").init(
        torch.Generator().manual_seed(3))
    batch = _batch(cfg)
    opt_cfg = make_opt_config(cfg, total_steps=2)
    runs = []
    for m in (None, mesh):
        p, b = _clone(params), batch
        if m is not None:
            p, b = distribute(p, specs, m), distribute(b, batch_specs(b, m),
                                                       m)
        state = init_state(opt_cfg, p)
        step = make_train_step(build_model(cfg, m, "cpu"), opt_cfg,
                               microbatches=2, compression=compression)
        metrics = []
        for _ in range(2):
            p, state, out = step(p, state, b)
            metrics += [out["loss"], out["grad_norm"]]
        runs.append([metrics] + [tree_flatten(full_tree(t))[0] for t in
                                 (p, state["opt"], state.get("ef", {}))])
    return runs


def _train_step_gaps(mesh) -> dict:
    """The mesh's two microbatched steps against one device's (see
    :func:`_max_gap`), without and with int8 error feedback.  With it,
    a gradient element whose quantization rounds the other way on the
    mesh (its value a few ulps off a rounding boundary) moves its error
    buffer element by one quantum (at most 2.01 times the leaf's largest
    residual) and its moments with it: those elements are counted and
    bounded, and every other element is held to TOL."""
    want, got = _step_runs(mesh, None)
    out = {"microbatches": {k: _max_gap(g, w) for k, g, w in zip(
        ("metrics", "params", "moments"), got, want)}}
    want, got = _step_runs(mesh, ErrorFeedbackInt8())
    flips = [(g - w).abs() > TOL["atol"] + TOL["rtol"] * w.abs()
             for g, w in zip(got[3], want[3])]
    assert len(got[2]) == 2 * len(flips)     # AdamW's m and v a parameter
    held = [f for f in flips for _ in range(2)]
    out["error_feedback"] = {
        "metrics": _max_gap(got[0], want[0]),
        "params": _max_gap(got[1], want[1]),
        "moments": _max_gap([torch.where(f, w, g) for g, w, f in
                             zip(got[2], want[2], held)], want[2]),
        "ef": _max_gap([torch.where(f, w, g) for g, w, f in
                        zip(got[3], want[3], flips)], want[3]),
        "flip_share": max(float(f.float().mean()) for f in flips),
        "flip_quanta": max((float((g - w).abs()[f].max()
                                  / (2.01 * w.abs().max()))
                            for g, w, f in zip(got[3], want[3], flips)
                            if f.any()), default=0.0)}
    return out


def _decode_gaps(arch, mesh) -> dict:
    """A prefill and one decode step of ``arch``'s smoke config on the
    mesh (the decode caches placed by the model's ``cache_spec``) and on
    one device: the gaps of the last prefill logits and of the decode
    logits, and whether the caches split the head dim."""
    cfg = configs.smoke_config(arch)
    plain, meshed = build_model(cfg, None, "cpu"), build_model(cfg, mesh,
                                                               "cpu")
    params, specs = plain.init(torch.Generator().manual_seed(3))
    batch = {k: v for k, v in _batch(cfg).items() if k != "labels"}
    pos = torch.full((B,), S)
    caches_spec = meshed.cache_spec(B, S + EXTRA)[1]
    with torch.no_grad():
        last, states = plain.prefill(params, batch)
        dec, _ = plain.decode_step(params, batch["tokens"][:, -1:],
                                   pad_caches(states, S, torch), pos)
        db = distribute(batch, batch_specs(batch, mesh), mesh)
        dparams = distribute(_clone(params), specs, mesh)
        got_last, dstates = meshed.prefill(dparams, db)
        caches = distribute(pad_caches(full_tree(dstates), S, torch),
                            caches_spec, mesh)
        got, _ = meshed.decode_step(dparams, db["tokens"][:, -1:], caches,
                                    distribute(pos, (None,), mesh))
    split = [sp[-1] == "model" for sp in tree_flatten(
        caches_spec, is_leaf=lambda x: isinstance(x, tuple))[0]]
    return {"last": _max_gap([got_last.full_tensor()], [last]),
            "decode": _max_gap([got.full_tensor()], [dec]),
            "split": any(split)}


def _worker(rank, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4)
    try:
        mesh = make_local_mesh(DATA, 2, device="cpu")
        group = mesh.get_group("model").group_name
        report = {}
        for arch, edit in CASES:
            name = _name(arch, edit)
            cfg = configs.smoke_config(arch).scaled(**edit)
            plain = build_model(cfg, None, "cpu")
            meshed = build_model(cfg, mesh, "cpu")
            params, specs = plain.init(torch.Generator().manual_seed(3))
            batch = _batch(cfg)
            opt_cfg = make_opt_config(cfg, total_steps=2)
            loss, aux, drops, grads = _expected(cfg, plain, _clone(params),
                                                batch)
            stepped = _clone(params)
            apply_updates(opt_cfg, stepped, tree_unflatten(
                grads, tree_flatten(params)[1]), init_state(opt_cfg, stepped))

            dparams = distribute(_clone(params), specs, mesh)
            state = init_state(opt_cfg, dparams)
            if rank == 0:
                store = {"params": params, "opt": init_state(opt_cfg,
                                                             params)}
                CheckpointStore(os.path.join(out_dir, name, "plain")).save(
                    1, store)
            save_state(CheckpointStore(os.path.join(out_dir, name, "mesh")),
                       1, {"params": dparams, "opt": state})
            blocks = [t.to_local().detach().clone()
                      for t, sp in zip(tree_flatten(dparams)[0],
                                       tree_flatten(specs, is_leaf=lambda x:
                                                    isinstance(x, tuple))[0])
                      if "model" in sp]
            meshed.moe_drops = [] if cfg.n_experts else None
            counter = collective_counter(keep_group=group)
            with counter:
                got_loss, metrics, dgrads = loss_and_grads(
                    meshed, dparams, distribute(batch, batch_specs(
                        batch, mesh), mesh))
                apply_updates(opt_cfg, dparams, dgrads, state)
            got_aux = metrics["aux"]
            report[name] = {
                "loss": [float(got_loss.full_tensor()), loss],
                "aux": [float(got_aux.full_tensor()) if torch.is_tensor(
                    got_aux) else got_aux, aux],
                "drops": [[int(c) for c in meshed.moe_drops or []], drops],
                "grads": _max_gap(tree_flatten(full_tree(dgrads))[0], grads),
                "step": _max_gap(tree_flatten(full_tree(dparams))[0],
                                 tree_flatten(stepped)[0]),
                "all_to_all": counter.collectives["all-to-all"]["count"],
                "weight_gathers": _weight_gathers(counter.gathered, blocks),
            }
        report = {"cases": report, "train_step": _train_step_gaps(mesh),
                  "decode": {a: _decode_gaps(a, mesh)
                             for a in DECODE_ARCHS}}
        if rank == 0:
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ranks")
    mp.spawn(_worker, args=(str(d / "init"), str(d)), nprocs=4, join=True)
    return d, json.loads((d / "report.json").read_text())


def _same_store(a, b) -> bool:
    cmp = filecmp.dircmp(a, b)
    return not (cmp.left_only or cmp.right_only or cmp.diff_files) and \
        all(filecmp.cmp(os.path.join(a, "chunks", f),
                        os.path.join(b, "chunks", f), shallow=False)
            for f in os.listdir(os.path.join(a, "chunks")))


def test_four_ranks_match_one_device(ranks):
    """Loss, aux loss, dropped pairs, gradients and one AdamW step of every
    family on the (2, 2) mesh against the single-device port; EP runs its
    all-to-alls on the model group, no model-sharded weight is gathered
    whole, and the stores written from the mesh and from one device are
    byte-identical."""
    root, report = ranks
    report = report["cases"]
    assert sorted(report) == sorted(_name(a, e) for a, e in CASES)
    for name, r in report.items():
        np.testing.assert_allclose(*r["loss"], **TOL, err_msg=name)
        np.testing.assert_allclose(*r["aux"], **TOL, err_msg=name)
        assert r["drops"][0] == r["drops"][1], name
        assert r["grads"] <= 0 and r["step"] <= 0, (name, r)
        assert r["weight_gathers"] == 0, (name, r)
        ep = name == "qwen3-moe-30b-a3b"
        assert (r["all_to_all"] > 0) == ep, (name, r)
        if ep:
            assert len(r["drops"][0]) == \
                configs.smoke_config("qwen3-moe-30b-a3b").n_layers
        assert _same_store(str(root / name / "plain"),
                           str(root / name / "mesh")), name


def test_four_ranks_train_step_microbatches(ranks):
    """Two train steps with two microbatches on the (2, 2) mesh (each a
    slice of the data-sharded batch): each step's loss and grad norm, the
    parameters and the AdamW moments against the single-device port's,
    within rtol = atol = 1e-5."""
    gaps = ranks[1]["train_step"]["microbatches"]
    assert all(v <= 0 for v in gaps.values()), gaps


def test_four_ranks_train_step_error_feedback(ranks):
    """The same two steps with int8 error feedback on DTensor gradients:
    the losses, grad norms and parameters within rtol = atol = 1e-5; the
    error buffer and the moments too, but for at most 1e-3 of a leaf's
    elements whose quantization rounded the other way, each by at most
    one quantum."""
    r = ranks[1]["train_step"]["error_feedback"]
    assert all(r[k] <= 0 for k in ("metrics", "params", "moments", "ef")), r
    assert r["flip_share"] <= 1e-3 and r["flip_quanta"] <= 1, r


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_four_ranks_decode_split_head_dim(ranks, arch):
    """A prefill and one decode step on the (2, 2) mesh, the caches' head
    dim split over the two model ranks (score partials summed over the
    model group), against the single-device port's logits within
    rtol = atol = 1e-5."""
    r = ranks[1]["decode"][arch]
    assert r["split"], r
    assert r["last"] <= 0 and r["decode"] <= 0, r


def test_local_mesh_matches_reference():
    """The port on its (1, 1) ``make_local_mesh()`` (DTensors, EP's
    all-to-alls on a one-rank model group) against the reference on its
    own: the MoE smoke model's loss, last prefill logits and one decode
    step on the reference's parameters, fp32, within 1e-5."""
    arch = "qwen3-moe-30b-a3b"
    ref_cfg, cfg = ref_configs.smoke_config(arch), configs.smoke_config(arch)
    batch = {k: v.numpy() for k, v in _batch(cfg).items()}
    ref = ref_build_model(ref_cfg, ref_local_mesh())
    ref_params, _ = ref.init(jax.random.key(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss = jax.jit(ref.loss)(ref_params, jb)[0]
    want_last, want_states = jax.jit(ref.prefill)(
        ref_params, {"tokens": jb["tokens"]})
    want_dec, _ = jax.jit(ref.decode_step)(
        ref_params, jb["tokens"][:, -1:], pad_caches(want_states, S, jnp),
        jnp.full((B,), S, jnp.int32))
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        model = build_model(cfg, mesh, "cpu")
        specs = model.init(torch.Generator())[1]
        params = params_from_numpy(to_numpy(ref_params), "cpu", mesh, specs)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tb = distribute(tb, batch_specs(tb, mesh), mesh)
        with torch.no_grad():
            loss = model.loss(params, tb)[0].full_tensor()
            last, states = model.prefill(params, {"tokens": tb["tokens"]})
            caches_spec = model.cache_spec(B, S + 4)[1]
            caches = distribute(pad_caches(full_tree(states), S, torch),
                                caches_spec, mesh)
            dec, _ = model.decode_step(
                params, tb["tokens"][:, -1:], caches,
                distribute(torch.full((B,), S), (None,), mesh))
        np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
        np.testing.assert_allclose(last.full_tensor().numpy(),
                                   np.asarray(want_last), **TOL)
        np.testing.assert_allclose(dec.full_tensor().numpy(),
                                   np.asarray(want_dec), **TOL)
    finally:
        dist.destroy_process_group()
