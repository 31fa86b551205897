"""The PyTorch port's MoE FFN and MoE models ≡ the JAX package, at smoke
configs on the CPU.

The reference runs jitted on ``repro.launch.mesh.make_local_mesh()``
(its "ep" mode inside ``shard_map`` on one rank of the "model" axis; one
compile costs less than its eager ``shard_map`` and scans); the
port's "ep" is the same capacity-bucketed dispatch on one device with no
``all_to_all``.  Inputs are drawn with numpy from a seed; parameters come
from the reference's ``init`` through ``params_from_numpy``.  Everything
is float32 with rtol = atol = 1e-5 (``TOL``), except where the
reference's own test states a looser bound: EP against TP 2e-5, decode
against forward 2e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import input_specs as ref_input_specs  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.model import mesh_axes_of  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402

from _torch_model_cases import (B, S, assert_case, close,  # noqa: E402
                                decode_errors, run_case, spec_shapes,
                                stack_logits, to_torch, zero_caches)

ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


def _ffn_inputs(seed, T=40):
    """A smoke MoE FFN's parameters and (2, T/2, d) activations."""
    cfg = configs.smoke_config("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(d, e)).astype(np.float32),
         "wi": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
         "wg": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
         "wo": (rng.normal(size=(e, f, d)) / 11).astype(np.float32)}
    x = rng.normal(size=(2, T // 2, d)).astype(np.float32)
    return cfg, p, x


def test_route_matches_reference():
    """Top-k weights (renormalised, descending), expert ids and the
    Switch-style aux loss on the first choice."""
    cfg, p, x = _ffn_inputs(0)
    x2d = x.reshape(-1, cfg.d_model)
    want = ref_moe._route(jnp.asarray(x2d), jnp.asarray(p["router"]), 2)
    got = moe._route(to_torch(x2d), to_torch(p["router"]), 2)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2])


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_ep_matches_reference_and_counts_drops(cf, mesh):
    """The EP dispatch at capacity factors that drop many pairs, some and
    none: output and aux loss against the reference's ``moe_ffn`` in
    ``shard_map``, and the port's dropped-pair count against one
    recomputed from the reference's routing (its ``pos``/``keep``)."""
    cfg, p, x = _ffn_inputs(1)
    cfg = cfg.scaled(capacity_factor=cf)
    want = jax.jit(lambda x_, p_: ref_moe.moe_ffn(
        x_, p_, cfg, mesh_axes_of(mesh)))(jnp.asarray(x), p)
    drops = []
    got = moe.moe_ffn(to_torch(x), params_from_numpy(p, "cpu"), cfg, drops)
    close(got[0], want[0])
    close(got[1], want[1])
    T, k, E = x.shape[0] * x.shape[1], cfg.experts_per_token, cfg.n_experts
    _, idx, _ = ref_moe._route(jnp.asarray(x.reshape(T, -1)),
                               jnp.asarray(p["router"]), k)
    one_hot = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(one_hot, axis=0) * one_hot - 1, axis=1)
    cap = int(max(8, round(cf * T * k / E)))
    assert moe.capacity(T, k, E, cf) == cap
    assert len(drops) == 1
    assert int(drops[0]) == int(jnp.sum(pos >= cap))
    if cf == 0.25:
        assert int(drops[0]) > 0
    if cf == 8.0:
        assert int(drops[0]) == 0


def test_capacity_rounds_half_to_even():
    """cap = max(8, round(cf·T·k/E)) with Python's round: 10.5 -> 10,
    11.5 -> 12, and never below 8."""
    assert moe.capacity(84, 1, 8, 1.0) == 10
    assert moe.capacity(92, 1, 8, 1.0) == 12
    assert moe.capacity(4, 8, 128, 1.25) == 8


def test_tp_matches_reference():
    """The dropless sorted dispatch (a matmul per non-empty expert group
    against the reference's ``ragged_dot``)."""
    cfg, p, x = _ffn_inputs(2)
    cfg = cfg.scaled(moe_mode="tp")
    want = ref_moe._moe_ffn_tp(jnp.asarray(x), p, cfg)
    got = moe.moe_ffn(to_torch(x), params_from_numpy(p, "cpu"), cfg)
    close(got[0], want[0])
    close(got[1], want[1])


def _stack_pair(cfg_a, cfg_b, seed, S_):
    """The port's hidden states and aux loss of two configs on the same
    parameters and tokens."""
    a, b = build_model(cfg_a, device="cpu"), build_model(cfg_b, device="cpu")
    params = a.init(torch.Generator().manual_seed(seed))[0]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg_a.vocab, size=(2, S_)))
    x = a._embed_inputs(params, {"tokens": toks})
    return a._stack(params, x), b._stack(params, x)


def test_moe_ep_equals_tp_without_drops():
    """Twin of the reference's test: with capacity to spare, EP and TP give
    the same hidden states (atol 2e-5) and aux loss (rtol 1e-5)."""
    cfg = configs.smoke_config("qwen3-moe-30b-a3b")
    (h1, _, a1), (h2, _, a2) = _stack_pair(
        dataclasses.replace(cfg, capacity_factor=8.0),
        dataclasses.replace(cfg, moe_mode="tp"), 5, 16)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-5)


def test_moe_capacity_drops_tokens():
    """Twin of the reference's test: low capacity changes the outputs."""
    cfg = configs.smoke_config("qwen3-moe-30b-a3b")
    (h1, _, _), (h2, _, _) = _stack_pair(
        dataclasses.replace(cfg, capacity_factor=0.25),
        dataclasses.replace(cfg, capacity_factor=8.0), 6, 32)
    assert float((h1 - h2).abs().max()) > 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def model_case(request, mesh):
    return run_case(request.param, mesh, 20 + ARCHS.index(request.param),
                    stack_logits)


@pytest.mark.parametrize("what", ["logits", "loss", "prefill", "decode"])
def test_model_matches_reference(model_case, what):
    """Logits, the loss (with 0.01 × the aux loss summed over the layers),
    prefill's last logits and caches, and one decode step (T = 2 tokens,
    capacity 8, so no pair drops) for qwen3-moe-30b-a3b and
    kimi-k2-1t-a32b at their smoke configs (8 experts, top-2, EP)."""
    assert_case(model_case, what)


def test_decode_matches_dropless_forward():
    """Teacher-forced EP decode (2 tokens a step: capacity 8, nothing
    dropped) against the forward of the dropless "tp" mode on the same
    parameters, within 2e-4; and each step's drop count is 0."""
    cfg = configs.smoke_config("qwen3-moe-30b-a3b")
    ep = build_model(cfg, device="cpu")
    tp = build_model(cfg.scaled(moe_mode="tp"), device="cpu")
    params = ep.init(torch.Generator().manual_seed(3))[0]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, S)))
    full = stack_logits(tp, params, {"tokens": toks})
    ep.moe_drops = []
    err = decode_errors(ep, params, toks, full, zero_caches(ep, S))
    assert err < 2e-4, err
    assert len(ep.moe_drops) == S * cfg.n_layers
    assert int(torch.stack(ep.moe_drops).sum()) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_init_match_reference(arch, mesh):
    """Every input of a prefill and a decode cell (the caches' shapes and
    dtypes), and the port's ``init`` tree (shapes and dtypes, the router
    in float32) against the reference's."""
    cfg, ref_cfg = configs.smoke_config(arch), ref_configs.smoke_config(arch)
    for kind in ("prefill", "decode"):
        shape = configs.ShapeConfig("tiny", kind, 32, 2)
        got = input_specs(cfg, shape)[0]
        want, _ = ref_input_specs(ref_cfg, shape, mesh)
        if kind == "decode":
            got, want = got["caches"], want["caches"]
        assert [s for s, _ in spec_shapes(got)] == \
            [s for s, _ in spec_shapes(want)]
        if kind == "decode":
            assert spec_shapes(got) == spec_shapes(want)
    from repro.models import build_model as ref_build
    want = jax.eval_shape(lambda k: ref_build(ref_cfg, mesh).init(k)[0],
                          jax.random.key(0))
    got = build_model(cfg, device="cpu").init(torch.Generator())[0]
    assert spec_shapes(got) == spec_shapes(want)
