"""The PyTorch port's RWKV-6 and RG-LRU blocks and their models
(rwkv6-1.6b, recurrentgemma-2b) ≡ the JAX package, at smoke configs on
the CPU.

Inputs are drawn with numpy from a seed; model parameters come from the
reference's ``init`` through ``params_from_numpy``.  Block-level and model
calls of the reference run under ``jax.jit`` (one compile costs less than
its eager scans).  Everything is
float32 with rtol = atol = 1e-5 (``TOL``), except where the reference's
own test states a looser bound: the chunked WKV against the per-step
recurrence 1e-3 (and against the reference's chunked WKV atol 1e-4),
decode against forward 2e-4.  The port's RG-LRU scan
combines pairs in another tree than ``jax.lax.associative_scan``, so the
two differ by float rounding only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import input_specs as ref_input_specs  # noqa: E402
from repro.models import rglru as ref_rg  # noqa: E402
from repro.models import rwkv6 as ref_rwkv  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import rglru, rwkv6  # noqa: E402

from _torch_model_cases import (B, S, assert_case, close,  # noqa: E402
                                decode_errors, run_case, spec_shapes,
                                stack_logits, to_numpy, to_torch,
                                zero_caches)

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


def _wkv_inputs(seed, S_=128, H=2, dh=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S_, H, dh)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(B, S_, H, dh)) * 0.5 - 0.5) \
        .astype(np.float32)
    u = (rng.normal(size=(H, dh)) * 0.5).astype(np.float32)
    state0 = (rng.normal(size=(B, H, dh, dh)) * 0.3).astype(np.float32)
    return r, k, v, logw, u, state0


@pytest.mark.parametrize("S_", [128, 16])
def test_wkv_chunked_matches_reference(S_):
    """Two chunks of 64, and one chunk shorter than 64, from a nonzero
    state: outputs and the final state.  Outputs reach ~19 here, and the
    chunk's exp(±cumulative decay) factors scale the rounding of sums the
    two packages order differently, so atol is 1e-4 (rtol 1e-5): within
    the 1e-3 that the reference's own test of ``wkv_chunked`` states."""
    args = _wkv_inputs(S_, S_)
    want = ref_rwkv.wkv_chunked(*map(jnp.asarray, args))
    got = rwkv6.wkv_chunked(*map(to_torch, args))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-4)


def test_wkv_chunked_equals_step_scan():
    """Twin of ``test_rwkv_chunked_equals_naive_scan``: the chunked form
    against the port's own ``wkv_step`` run over the sequence (1e-3, the
    reference test's bound), and ``wkv_step`` against the reference's."""
    r, k, v, logw, u, state0 = map(to_torch, _wkv_inputs(7))
    state0 = torch.zeros_like(state0)
    o_fast, s_fast = rwkv6.wkv_chunked(r, k, v, logw, u, state0)
    outs, s = [], state0
    for t in range(r.shape[1]):
        o_t, s = rwkv6.wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, s)
        outs.append(o_t)
    np.testing.assert_allclose(o_fast.numpy(), torch.stack(outs, 1).numpy(),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(s_fast.numpy(), s.numpy(), atol=1e-3,
                               rtol=1e-3)
    args = [a[:, 5].numpy() for a in (r, k, v, logw)] + [u.numpy(),
                                                         s.numpy()]
    want = ref_rwkv.wkv_step(*map(jnp.asarray, args))
    for g, w in zip(rwkv6.wkv_step(*map(to_torch, args)), want):
        close(g, w)


def test_wkv_length_must_be_a_whole_number_of_chunks():
    """S = 96 is not a multiple of min(64, S): the reference asserts, the
    port raises, and neither pads."""
    args = _wkv_inputs(8, 96)
    with pytest.raises(AssertionError):
        ref_rwkv.wkv_chunked(*map(jnp.asarray, args))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6.wkv_chunked(*map(to_torch, args))


def _block_params(arch, key):
    """The reference's mixer params of one block of ``arch``'s smoke
    config, in both packages' forms."""
    cfg = ref_configs.smoke_config(arch)
    init = ref_rwkv.init_rwkv if arch == "rwkv6-1.6b" else \
        ref_rg.init_rglru
    p, _ = init(jax.random.key(key), cfg, jnp.float32, False)
    return cfg, p, params_from_numpy(to_numpy(p), "cpu")


def test_rwkv_block_and_decode_match_reference():
    """The time-mix block over a sequence from a nonzero shift and state,
    then one decode step from its outputs; and the channel-mix FFN."""
    cfg, p, tp = _block_params("rwkv6-1.6b", 3)
    rng = np.random.default_rng(3)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    x = rng.normal(size=(B, 64, d)).astype(np.float32)
    shift = rng.normal(size=(B, d)).astype(np.float32)
    st = (rng.normal(size=(B, h, dh, dh)) * 0.1).astype(np.float32)
    want = jax.jit(lambda *a: ref_rwkv.rwkv_block(a[0], p, cfg, *a[1:]))(
        jnp.asarray(x), jnp.asarray(shift), jnp.asarray(st))
    got = rwkv6.rwkv_block(to_torch(x), tp, cfg, to_torch(shift),
                           to_torch(st))
    for g, w in zip(got, want):
        close(g, w)
    x1 = x[:, :1] * 0.5
    want = jax.jit(lambda *a: ref_rwkv.rwkv_decode(a[0], p, cfg, *a[1:]))(
        jnp.asarray(x1), want[1], want[2])
    got = rwkv6.rwkv_decode(to_torch(x1), tp, cfg, got[1], got[2])
    for g, w in zip(got, want):
        close(g, w)
    fp, _ = ref_rwkv.init_rwkv_ffn(jax.random.key(4), cfg, jnp.float32,
                                   False)
    want = jax.jit(ref_rwkv.rwkv_ffn)(jnp.asarray(x), fp, jnp.asarray(shift))
    got = rwkv6.rwkv_ffn(to_torch(x), params_from_numpy(to_numpy(fp), "cpu"),
                         to_torch(shift))
    for g, w in zip(got, want):
        close(g, w)


def test_rglru_block_and_decode_match_reference():
    """The recurrent block over a sequence from a nonzero conv window and
    state (the scan against ``associative_scan``), then one decode step
    from its outputs."""
    cfg, p, tp = _block_params("recurrentgemma-2b", 5)
    rng = np.random.default_rng(5)
    d, dr = cfg.d_model, cfg.d_rnn
    x = rng.normal(size=(B, 37, d)).astype(np.float32)
    conv = rng.normal(size=(B, rglru.CONV_W - 1, dr)).astype(np.float32)
    h0 = rng.normal(size=(B, dr)).astype(np.float32)
    want = jax.jit(lambda *a: ref_rg.rglru_block(a[0], p, cfg, *a[1:]))(
        jnp.asarray(x), jnp.asarray(conv), jnp.asarray(h0))
    got = rglru.rglru_block(to_torch(x), tp, cfg, to_torch(conv),
                            to_torch(h0))
    for g, w in zip(got, want):
        close(g, w)
    x1 = x[:, :1] * 0.5
    want = jax.jit(lambda *a: ref_rg.rglru_decode(a[0], p, cfg, *a[1:]))(
        jnp.asarray(x1), want[1], want[2])
    got = rglru.rglru_decode(to_torch(x1), tp, cfg, got[1], got[2])
    for g, w in zip(got, want):
        close(g, w)


@pytest.fixture(scope="module", params=ARCHS)
def model_case(request, mesh):
    return run_case(request.param, mesh, 30 + ARCHS.index(request.param),
                    stack_logits)


@pytest.mark.parametrize("what", ["logits", "loss", "prefill", "decode"])
def test_model_matches_reference(model_case, what):
    """Logits, loss, prefill's last logits and states (WKV state and both
    token shifts; RG-LRU state and conv window; the local blocks' rolled
    K/V buffers) and one decode step, for rwkv6-1.6b and
    recurrentgemma-2b (rglru, rglru, local; window 8 under 16 tokens)."""
    assert_case(model_case, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Twin of the reference's test: teacher-forced decode logits equal
    the full forward's at every position (2e-4; the port alone, its
    forward is held against the reference above)."""
    cfg = configs.smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))[0]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, S)))
    full = stack_logits(model, params, {"tokens": toks})
    err = decode_errors(model, params, toks, full, zero_caches(model, S))
    assert err < 2e-4, err


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_init_match_reference(arch, mesh):
    """Every input of a prefill and a decode cell (the recurrent states in
    float32, the shifts, conv windows and K/V in the model's dtype), and
    the port's ``init`` tree, against the reference's."""
    cfg, ref_cfg = configs.smoke_config(arch), ref_configs.smoke_config(arch)
    for kind in ("prefill", "decode"):
        shape = configs.ShapeConfig("tiny", kind, 64, 2)
        got = input_specs(cfg, shape)[0]
        want, _ = ref_input_specs(ref_cfg, shape, mesh)
        if kind == "decode":
            got, want = got["caches"], want["caches"]
        assert [s for s, _ in spec_shapes(got)] == \
            [s for s, _ in spec_shapes(want)]
    for dtype in ("float32", "bfloat16"):
        got = input_specs(cfg.scaled(dtype=dtype),
                          configs.ShapeConfig("tiny", "decode", 64, 2))[0][
                              "caches"]
        want, _ = ref_input_specs(ref_cfg.scaled(dtype=dtype),
                                  configs.ShapeConfig("tiny", "decode", 64,
                                                      2), mesh)
        assert spec_shapes(got) == spec_shapes(want["caches"])
    want = jax.eval_shape(
        lambda k: ref_build_model(ref_cfg, mesh).init(k)[0],
        jax.random.key(0))
    got = build_model(cfg, device="cpu").init(torch.Generator())[0]
    assert spec_shapes(got) == spec_shapes(want)
