"""The PyTorch port's training stack ≡ the JAX package's, on the CPU.

``train/optim.py`` (AdamW and Adafactor, factored or not, with and without
momentum, bf16 state, the chunked branch), ``train/compression.py`` (int8
error feedback) and ``train/loop.py`` (the train step, microbatching) are
held against ``repro.train`` on the same numpy inputs, and the port's
autograd gradients against ``jax.grad`` of the reference's loss for every
model family at its smoke config.  The reference's models run jitted on
``repro.launch.mesh.make_local_mesh()`` with their ``init`` parameters
carried over by ``params_from_numpy``.  Tolerances: float32 math rtol
1e-5, atol 1e-6 (``OPT_TOL``); a bf16 leaf one bf16 rounding step
(rtol 2**-7, ``BF16_TOL``); gradients rtol 1e-4, atol 1e-5
(``GRAD_TOL``), and so the optimizer state after a train step; its
parameters and metrics rtol 1e-4, atol 1e-6 (``STEP_TOL``), but for
rounding flips (``assert_flips``): Adam's
normalised update of a gradient component within float noise of zero,
and the int8 rounding of an error-feedback residual, may go either way,
so at most 0.1 % of a leaf's elements may differ by more, each by at
most the flip's size; quantization bit for bit.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.train import compression as ref_comp  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.manager import tree_from_numpy  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.train import compression, loop, optim  # noqa: E402

from _torch_model_cases import leaves, to_numpy  # noqa: E402

OPT_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2**-7, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


def as_np(x):
    """A port tensor or a reference array as float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_trees(got, want, tol=OPT_TOL):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        t = BF16_TOL if a.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(as_np(a), as_np(b), **t)


def assert_flips(got, want, bound, tol=STEP_TOL, share=1e-3):
    """Leaf for leaf within ``tol`` but for at most ``share`` of each
    leaf's elements, which differ by at most ``bound`` (a float, or a
    function of the reference leaf)."""
    for a, b in zip(leaves(got), leaves(want)):
        a, b = as_np(a), as_np(b)
        assert a.shape == b.shape
        off = ~np.isclose(a, b, **tol)
        lim = bound(b) if callable(bound) else bound
        assert off.sum() <= share * a.size, (off.sum(), a.size)
        assert np.all(np.abs(a - b)[off] <= lim), \
            (np.abs(a - b)[off].max(), lim)


# ------------------------------------------------------------ optimizer --
def _opt_tree(rng):
    """Leaves of ndim 1, 2 and 3, factored and not (a unit dim), one bf16;
    as numpy arrays."""
    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"b": f32(7), "col": f32(5, 1), "w": f32(6, 4),
            "stack": f32(3, 4, 5), "thin": f32(3, 1, 5),
            "half": f32(4, 6).astype(ml_dtypes.bfloat16)}


OPT_CASES = {
    "adamw": dict(kind="adamw"),
    "adafactor": dict(kind="adafactor"),
    "adafactor-no-momentum": dict(kind="adafactor", momentum=False),
    "adafactor-bf16": dict(kind="adafactor", state_dtype="bfloat16",
                           momentum=False),
}


@pytest.mark.parametrize("chunk", [False, True])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_matches_reference(case, chunk, monkeypatch):
    """Two steps of ``apply_updates`` from the same parameters and
    gradients: parameters, state and metrics.  ``chunk`` lowers
    ``_CHUNK_ELEMS`` in both packages to 16, so the ndim-3 leaves take the
    per-slice branch and the larger leaves' norms the per-slice sums."""
    if chunk:
        monkeypatch.setattr(ref_optim, "_CHUNK_ELEMS", 16)
        monkeypatch.setattr(optim, "_CHUNK_ELEMS", 16)
    kw = dict(OPT_CASES[case], warmup=1, total_steps=4, lr=1e-2)
    ref_cfg, cfg = ref_optim.OptConfig(**kw), optim.OptConfig(**kw)
    rng = np.random.default_rng(3)
    params_np = _opt_tree(rng)
    grads_np = [_opt_tree(rng) for _ in range(2)]
    ref_p = jax.tree.map(jnp.asarray, params_np)
    ref_s = ref_optim.init_state(ref_cfg, ref_p)
    p = tree_from_numpy(params_np, "cpu")
    s = optim.init_state(cfg, p)
    assert [tuple(t.shape) for t in leaves(s["opt"])] == \
        [tuple(np.shape(t)) for t in leaves(ref_s["opt"])]
    for g_np in grads_np:
        ref_p, ref_s, ref_m = ref_optim.apply_updates(
            ref_cfg, ref_p, jax.tree.map(jnp.asarray, g_np), ref_s)
        p, s, m = optim.apply_updates(cfg, p, tree_from_numpy(g_np, "cpu"),
                                      s)
    assert_trees(p, ref_p)
    assert_trees(s["opt"], ref_s["opt"])
    assert int(s["step"]) == int(ref_s["step"]) == 2
    assert s["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), **OPT_TOL)


def test_schedule_matches_reference():
    """Step 0, inside and at the end of the warm-up, mid-decay, at and past
    ``total_steps``."""
    kw = dict(lr=3e-4, warmup=10, total_steps=50)
    ref_cfg, cfg = ref_optim.OptConfig(**kw), optim.OptConfig(**kw)
    for step in (0, 3, 10, 30, 50, 60):
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = ref_optim.schedule(ref_cfg, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)
    assert float(optim.schedule(cfg, torch.tensor(0))) == 0.0


# ---------------------------------------------------------- compression --
@pytest.mark.parametrize("kind", ["ties", "random"])
def test_quantize_bit_equal(kind):
    """``q`` and ``scale`` bit for bit, .5 ties (round half to even) and
    the clip included."""
    if kind == "ties":
        x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0,
                      3.5, 0.0], np.float32)
    else:
        x = (np.random.default_rng(4).standard_normal(4099) * 3e-3) \
            .astype(np.float32)
    q, scale = compression._quantize(torch.from_numpy(x))
    rq, rscale = ref_comp._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.numpy().tobytes() == np.asarray(rscale).tobytes()
    np.testing.assert_array_equal(
        compression._dequantize(q, scale).numpy(),
        np.asarray(ref_comp._dequantize(rq, rscale)))
    if kind == "ties":
        assert q.tolist()[1:8] == [0, 2, 2, 0, -2, -2, 126]


def test_error_feedback_unbiased_and_wire_bytes():
    """Σ transmitted + the final residual == Σ true gradients over 20 steps
    (atol 1e-4, the reference's own bound); ``wire_bytes`` equals the
    reference's on the same tree."""
    comp = compression.ErrorFeedbackInt8()
    rng = np.random.default_rng(5)
    state, true, sent = {}, torch.zeros(32), torch.zeros(32)
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.standard_normal(32)
                                   .astype(np.float32))}
        out, state = comp.apply(g, state)
        true += g["w"]
        sent += out["w"]
    np.testing.assert_allclose((sent + state["ef"]["w"]).numpy(),
                               true.numpy(), rtol=1e-4, atol=1e-4)
    tree = _opt_tree(rng)
    assert compression.ErrorFeedbackInt8.wire_bytes(
        tree_from_numpy(tree, "cpu")) == \
        ref_comp.ErrorFeedbackInt8.wire_bytes(jax.tree.map(jnp.asarray, tree))


# ------------------------------------------------------------ gradients --
GRAD_CASES = {
    "qwen3-4b": ("qwen3-4b", None),
    "starcoder2-3b": ("starcoder2-3b", None),
    "qwen3-moe-ep": ("qwen3-moe-30b-a3b", None),
    "qwen3-moe-tp": ("qwen3-moe-30b-a3b", dict(moe_mode="tp")),
    "rwkv6-1.6b": ("rwkv6-1.6b", None),
    "recurrentgemma-2b": ("recurrentgemma-2b", None),
    "whisper-base": ("whisper-base", None),
    "internvl2-76b": ("internvl2-76b", None),
}


def _grad_batch(cfg, seed, B=2, S=16):
    """Tokens and labels (a few masked) and the stub frontend's inputs."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, size=(B, S))
    labels[:, :2] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
             "labels": labels}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch, edit, mesh, key=1):
    """(reference model, its params, port model, the same params)."""
    ref_cfg, cfg = ref_configs.smoke_config(arch), configs.smoke_config(arch)
    if edit:
        ref_cfg, cfg = ref_cfg.scaled(**edit), cfg.scaled(**edit)
    ref = ref_build_model(ref_cfg, mesh)
    ref_params, _ = ref.init(jax.random.key(key))
    return ref, ref_params, build_model(cfg, device="cpu"), \
        params_from_numpy(to_numpy(ref_params), "cpu")


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grads_match_jax_grad(case, mesh):
    """Autograd of the port's ``loss`` ≡ ``jax.grad`` of the reference's,
    leaf for leaf, with the loss itself."""
    arch, edit = GRAD_CASES[case]
    ref, ref_params, model, params = _pair(arch, edit, mesh)
    batch = _grad_batch(model.cfg, 7)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        ref.loss, has_aux=True))(ref_params,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = loop.loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), **GRAD_TOL)
    assert_trees(grads, ref_grads, GRAD_TOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-2b",
                                  "whisper-base"])
def test_remat_same_grads_and_drops(arch):
    """``cfg.remat`` recomputes each period (each encoder and decoder
    block) in the backward pass: the loss, every gradient and the MoE
    dropped-pair counts (one a call) are those without it."""
    cfg = configs.smoke_config(arch).scaled(capacity_factor=0.5)
    batch = {k: torch.from_numpy(v) for k, v in _grad_batch(cfg, 8).items()}
    out = {}
    for remat in (False, True):
        model = build_model(cfg.scaled(remat=remat), device="cpu")
        params = model.init(torch.Generator().manual_seed(2))[0]
        model.moe_drops = []
        loss, _, grads = loop.loss_and_grads(model, params, batch)
        out[remat] = (loss, leaves(grads), [int(c) for c in model.moe_drops])
    assert float(out[True][0]) == float(out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[True][2] == out[False][2]
    if cfg.n_experts:
        assert len(out[True][2]) == cfg.n_layers and sum(out[True][2]) > 0


def _leaf_grad_nodes(loss) -> list:
    """The names of the autograd nodes that feed a parameter leaf's
    gradient accumulator directly."""
    seen, out, todo = set(), [], [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and type(nxt).__name__ == "AccumulateGrad":
                out.append(type(node).__name__)
            todo.append(nxt)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_stacked_leaves_split_once(remat):
    """Each stacked leaf reaches the loss through one ``unbind`` (whose
    backward stacks the layers' gradients once), never through a
    per-layer ``select`` (whose backward writes a full-size zero tensor
    a layer)."""
    cfg = configs.smoke_config("qwen3-4b").scaled(remat=remat)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))[0]
    for p in leaves(params):
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in _grad_batch(cfg, 1).items()}
    nodes = _leaf_grad_nodes(model.loss(params, batch)[0])
    assert "SelectBackward0" not in nodes
    assert nodes.count("UnbindBackward0") == len(leaves(params["periods"]))


# ----------------------------------------------------------- train step --
def _ref_step_carrying_ef(ref, ref_cfg):
    """The reference's train step with its error-feedback buffer carried
    to the next step: its ``apply_updates`` returns only "step" and
    "opt", so ``make_train_step`` drops "ef" after every step (ROADMAP
    §3)."""
    comp = ref_comp.ErrorFeedbackInt8()

    def step(params, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(ref.loss, has_aux=True)(
            params, batch)
        grads, opt_state = comp.apply(grads, opt_state)
        params, new_state, metrics = ref_optim.apply_updates(
            ref_cfg, params, grads, opt_state)
        return params, dict(new_state, ef=opt_state["ef"]), \
            dict(aux, **metrics, loss=loss)
    return step


@pytest.mark.parametrize("mode", ["single", "microbatches", "compression"])
def test_train_step_matches_reference(mode, mesh):
    """Two train steps of qwen3-4b's smoke config from the reference's
    parameters on the same batch of 4: the port's parameters, optimizer
    state (and error-feedback buffer) and metrics against the
    reference's."""
    ref, ref_params, model, params = _pair("qwen3-4b", None, mesh, key=3)
    ref_cfg = ref_loop.make_opt_config(ref.cfg, total_steps=10)
    cfg = loop.make_opt_config(model.cfg, total_steps=10)
    ref_cfg = dataclasses.replace(ref_cfg, warmup=1)
    cfg = dataclasses.replace(cfg, warmup=1)
    mb = 2 if mode == "microbatches" else 1
    if mode == "compression":
        ref_step = jax.jit(_ref_step_carrying_ef(ref, ref_cfg))
        step = loop.make_train_step(
            model, cfg, compression=compression.ErrorFeedbackInt8())
    else:
        ref_step = jax.jit(ref_loop.make_train_step(ref, ref_cfg,
                                                    microbatches=mb))
        step = loop.make_train_step(model, cfg, microbatches=mb)
    ref_state = ref_optim.init_state(ref_cfg, ref_params)
    state = optim.init_state(cfg, params)
    batch = _grad_batch(model.cfg, 9, B=4)
    for _ in range(2):
        ref_params, ref_state, ref_m = ref_step(
            ref_params, ref_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(
            params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    # a flipped normalised update moves an element by at most 2 lr a step
    flip = 2 * 2 * cfg.lr * (1 + cfg.weight_decay)
    assert_flips(params, ref_params, flip)
    # the state holds the gradients' moments, held as the gradients are
    assert_trees(state["opt"], ref_state["opt"], GRAD_TOL)
    assert int(state["step"]) == 2
    if mode == "compression":
        # a flipped rounding moves a residual by one quantum: its leaf's
        # largest |residual| is half a quantum
        assert_flips(state["ef"], ref_state["ef"],
                     lambda b: 2.01 * np.abs(b).max())
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), **STEP_TOL)


def test_reference_train_step_drops_error_feedback(mesh):
    """The reference's ``make_train_step`` with compression returns a state
    without "ef", so each step starts its error feedback from zero; the
    port's keeps the buffer."""
    ref, ref_params, model, params = _pair("qwen3-4b", None, mesh, key=3)
    ref_cfg = ref_loop.make_opt_config(ref.cfg, total_steps=10)
    cfg = loop.make_opt_config(model.cfg, total_steps=10)
    batch = _grad_batch(model.cfg, 9, B=2)
    _, ref_state, _ = jax.jit(ref_loop.make_train_step(
        ref, ref_cfg, compression=ref_comp.ErrorFeedbackInt8()))(
        ref_params, ref_optim.init_state(ref_cfg, ref_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert "ef" not in ref_state
    _, state, _ = loop.make_train_step(
        model, cfg, compression=compression.ErrorFeedbackInt8())(
        params, optim.init_state(cfg, params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "ef" in state and any(bool(e.any()) for e in leaves(state["ef"]))


def test_init_train_state_marks_leaves_and_returns_no_specs():
    cfg = configs.smoke_config("starcoder2-3b")
    model = build_model(cfg, device="cpu")
    params, state, specs = loop.init_train_state(
        model, loop.make_opt_config(cfg), torch.Generator().manual_seed(0))
    assert specs == model.init(torch.Generator())[1]
    assert all(p.requires_grad for p in leaves(params))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
