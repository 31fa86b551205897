"""Shared helpers of the model-stack parity tests (``test_torch_moe.py``,
``test_torch_recurrent.py``, ``test_torch_encdec.py``): one smoke config
run through both packages on the same parameters and inputs.

The reference runs on ``repro.launch.mesh.make_local_mesh()``, each call
under ``jax.jit`` (one compile costs less than its eager scans); its
``init`` parameters reach the port through ``params_from_numpy``, and
both packages get the same numpy inputs.  Everything is float32.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model

from repro_torch import configs
from repro_torch.models import build_model, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, EXTRA = 2, 16, 4


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(x):
    return torch.from_numpy(np.array(x))


def leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in leaves(e)]
    return [x]


def batch_of(cfg, rng):
    """Tokens, labels (some masked) and the stub frontend's inputs."""
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
             "labels": rng.integers(-1, cfg.vocab, size=(B, S))}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree.clone()


def pad_caches(states, n_prompt, pkg):
    """Prefill states -> decode caches of n_prompt + EXTRA positions: a
    global attention cache (self-attention K/V as long as the prompt) is
    zero-padded; rolling buffers, cross-attention K/V and recurrent
    states stay."""
    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if key not in ("k", "v") or x.shape[-3] != n_prompt:
            return x
        width = [(0, 0)] * x.ndim
        width[-3] = (0, EXTRA)
        if pkg is jnp:
            return jnp.pad(x, width)
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, EXTRA))
    return walk(states)


def run_case(arch, mesh, seed, logits_fn, cfg_edit=None):
    """Both packages' logits (``logits_fn(model, params, batch)``), loss,
    prefill and one decode step on the reference's parameters and one
    numpy batch, for the smoke config of ``arch`` (``cfg_edit`` applied
    to both packages' configs)."""
    ref_cfg, cfg = ref_configs.smoke_config(arch), configs.smoke_config(arch)
    if cfg_edit:
        ref_cfg, cfg = cfg_edit(ref_cfg), cfg_edit(cfg)
    rng = np.random.default_rng(seed)
    batch = batch_of(cfg, rng)
    ref = ref_build_model(ref_cfg, mesh)
    ref_params, _ = ref.init(jax.random.key(1))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(to_numpy(ref_params), "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: to_torch(v) for k, v in batch.items()}
    out = {}
    for name, pkg, m, p, b in (("ref", jnp, ref, ref_params, jb),
                               ("port", torch, model, params, tb)):
        call = jax.jit if pkg is jnp else (lambda f: f)
        last, states = call(m.prefill)(p, {k: v for k, v in b.items()
                                           if k != "labels"})
        # the port's decode writes its caches in place: decode from a copy
        caches = pad_caches(states if pkg is jnp else clone(states), S, pkg)
        tok = b["tokens"][:, -1:]
        pos = jnp.full((B,), S, jnp.int32) if pkg is jnp else \
            torch.full((B,), S)
        out[name] = {"logits": call(lambda p_, b_: logits_fn(m, p_, b_))(p, b),
                     "loss": call(m.loss)(p, b)[0],
                     "prefill": (last, states),
                     "decode": call(m.decode_step)(p, tok, caches, pos)}
    return out


def assert_case(case, what, **tol):
    got, want = leaves(case["port"][what]), leaves(case["ref"][what])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        close(g, w, **tol)


def stack_logits(model, params, batch):
    """A decoder-only model's logits at every position."""
    h, _, _ = model._stack(params, model._embed_inputs(params, batch))
    return model.logits(params, h)


def zero_caches(model, n):
    """Zero decode caches of n positions from ``model.cache_spec``."""
    spec = model.cache_spec(B, n)[0]

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return torch.zeros(x.shape, dtype=x.dtype)
    return walk(spec)


def decode_errors(model, params, toks, full, caches):
    """Max |decode logits - forward logits| over the positions, feeding
    the tokens one at a time (teacher forcing)."""
    errs = []
    for t in range(toks.shape[1]):
        lg, caches = model.decode_step(params, toks[:, t:t + 1], caches,
                                       torch.full((B,), t))
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    return max(errs)


def spec_shapes(tree):
    return [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in leaves(tree)]
