"""The PyTorch port's configs and attention-family model stack ≡ the JAX
package, at smoke configs on the CPU.

The reference runs eagerly on ``repro.launch.mesh.make_local_mesh()`` (its
axes are Auto, which its sharding constraints accept).  Its parameters,
drawn by its own ``init``, reach the port through ``params_from_numpy``,
and both packages get the same inputs, drawn with numpy.  Everything is
float32; the tolerance is rtol = atol = 1e-5 (``TOL``): the port's
attention is one ``scaled_dot_product_attention`` call where the reference
computes jnp einsums (blockwise above 512 positions), so the two differ by
float rounding only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import attention as ref_att  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import input_specs as ref_input_specs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import (build_model, input_specs,  # noqa: E402
                                params_from_numpy)
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen3-4b", "starcoder2-3b", "internvl2-76b", "qwen3-4b-local"]


def smoke(arch, pkg):
    """The smoke config of ``arch``; "qwen3-4b-local" alternates global and
    windowed blocks (window 8)."""
    if arch == "qwen3-4b-local":
        return pkg.smoke_config("qwen3-4b").scaled(
            block_pattern=("attn", "local"), window=8)
    return pkg.smoke_config(arch)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


# ------------------------------------------------------------- configs --
def test_all_full_configs_construct():
    """Twin of the reference's test on the port's configs, which equal the
    reference's field for field, as do the smoke variants, the shapes and
    the cells."""
    assert configs.ARCHS == ref_configs.ARCHS
    for a in configs.ARCHS:
        cfg = configs.get_config(a)
        assert cfg.d_model % cfg.n_heads == 0 or cfg.d_head
        assert cfg.head_dim % 16 == 0
        if cfg.n_experts:
            assert cfg.n_experts % 16 == 0
        assert len(cfg.pattern()) == cfg.n_layers
        for get in ("get_config", "smoke_config"):
            assert dataclasses.asdict(getattr(configs, get)(a)) == \
                dataclasses.asdict(getattr(ref_configs, get)(a))
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert list(configs.cells(True)) == list(ref_configs.cells(True))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_arch_builds_prefills_and_decodes(arch):
    """Every config of the repo serves on the port at its smoke size:
    ``build_model`` constructs it, ``prefill`` and two ``decode_step``s run
    on caches shaped by ``cache_spec``, and the logits are finite."""
    cfg = configs.smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))[0]
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))}
    n = 8
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.randn(2, cfg.n_patches, cfg.d_model)
        n += cfg.n_patches
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.randn(2, cfg.encoder_frames, cfg.d_model)
    last, states = model.prefill(params, batch)
    assert tuple(last.shape) == (2, 1, cfg.padded_vocab)
    spec = model.cache_spec(2, n + 2)[0]
    assert len(_leaves(states)) == len(_leaves(spec))
    caches = _zeros_like(spec)
    tok = batch["tokens"][:, -1:]
    for t in range(2):
        lg, caches = model.decode_step(params, tok, caches,
                                       torch.full((2,), n + t))
        assert bool(torch.isfinite(lg[..., :cfg.vocab]).all())
        tok = lg[:, 0, :cfg.vocab].argmax(-1, keepdim=True)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype)


# -------------------------------------------------------------- layers --
def test_layers_match_reference():
    """rmsnorm, layernorm, apply_rope (the half-split pairs), the gated
    MLP, embed lookup and the fp32 unembedding."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    close(layers.rmsnorm(to_torch(x), to_torch(w)),
          ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    ln = {"w": w, "b": rng.normal(size=64).astype(np.float32)}
    close(layers.layernorm(to_torch(x), {k: to_torch(v) for k, v in
                                         ln.items()}),
          ref_layers.layernorm(jnp.asarray(x), ln))
    h = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7))
    close(layers.apply_rope(to_torch(h), to_torch(pos), 10_000.0),
          ref_layers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 10_000.0))
    p = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
         (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    close(layers.mlp(to_torch(x), params_from_numpy(p, "cpu")),
          ref_layers.mlp(jnp.asarray(x), p))
    emb = rng.normal(size=(256, 64)).astype(np.float32)
    tok = rng.integers(0, 256, size=(2, 7))
    close(layers.embed_lookup(to_torch(emb), to_torch(tok)),
          ref_layers.embed_lookup(jnp.asarray(emb), jnp.asarray(tok)))
    got = layers.unembed(to_torch(x), to_torch(emb))
    assert got.dtype == torch.float32
    close(got, ref_layers.unembed(jnp.asarray(x), jnp.asarray(emb)))


@pytest.mark.parametrize("window,offset", [(0, 0), (3, 0), (4, 5)])
def test_causal_mask_matches_reference(window, offset):
    close(att.causal_mask(6, 12, window, offset),
          ref_att.causal_mask(6, 12, window, offset), rtol=0, atol=0)


def _attn_inputs(arch, S, seed):
    cfg = smoke(arch, ref_configs)
    rng = np.random.default_rng(seed)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for k, s
         in (("wq", (d, h * dh)), ("wk", (d, kv * dh)), ("wv", (d, kv * dh)),
             ("wo", (h * dh, d)))}
    if cfg.qk_norm:
        p["q_norm"] = (1 + rng.normal(size=dh) / 4).astype(np.float32)
        p["k_norm"] = (1 + rng.normal(size=dh) / 4).astype(np.float32)
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("S", [24, 1024])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_matches_reference(S, window):
    """Global and windowed blocks, below and above the reference's switch
    to its blockwise path at 512 positions, qk-norm and GQA (4 query heads
    on 2 KV heads): the output and the decode cache (the rolled buffer of
    the last ``window`` positions for a windowed block)."""
    cfg, p, x = _attn_inputs("qwen3-4b", S, 10 + S + window)
    want = ref_att.attention(jnp.asarray(x), p, cfg, window=window,
                             return_kv=True)
    got = att.attention(to_torch(x), params_from_numpy(p, "cpu"), cfg,
                        window=window, return_kv=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode_matches_reference(window):
    """One decode step against a cache at ragged positions: the output and
    both caches, for the full cache and the rolling buffer (positions
    below and past the window)."""
    cfg, p, x = _attn_inputs("qwen3-4b", 1, 30 + window)
    rng = np.random.default_rng(31 + window)
    S_max = window or 20
    ck, cv = (rng.normal(size=(2, S_max, cfg.n_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    pos = np.array([3, 13], np.int32)
    want = ref_att.attention_decode(jnp.asarray(x), p, cfg, jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.asarray(pos),
                                    window=window)
    got = att.attention_decode(to_torch(x), params_from_numpy(p, "cpu"),
                               cfg, to_torch(ck), to_torch(cv),
                               to_torch(pos).long(), window=window)
    for g, w in zip(got, want):
        close(g, w)


def test_cross_attention_matches_reference():
    cfg, p, x = _attn_inputs("qwen3-4b", 5, 40)
    enc = np.random.default_rng(41).normal(size=(2, 9, cfg.d_model)) \
        .astype(np.float32)
    kv_want = ref_att.encode_kv(jnp.asarray(enc), p, cfg)
    tp = params_from_numpy(p, "cpu")
    kv_got = att.encode_kv(to_torch(enc), tp, cfg)
    for g, w in zip(kv_got, kv_want):
        close(g, w)
    close(att.cross_attention(to_torch(x), tp, cfg, *kv_got),
          ref_att.cross_attention(jnp.asarray(x), p, cfg, *kv_want))


# --------------------------------------------------------------- model --
B, S, EXTRA = 2, 16, 4


def _batch(cfg, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
             "labels": rng.integers(-1, cfg.vocab, size=(B, S))}
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _pad_caches(states, S_ctx, xp):
    """Prefill states -> decode caches of S_ctx positions: a global block's
    cache is zero-padded past the prompt, a rolling buffer stays."""
    def pad(c):
        extra = S_ctx - c.shape[-3]
        if extra <= 0:
            return c
        width = [(0, 0)] * c.ndim
        width[-3] = (0, extra)
        return xp.pad(c, width) if xp is jnp else \
            torch.nn.functional.pad(c, (0, 0, 0, 0, 0, extra))
    return jax.tree.map(pad, states) if xp is jnp else \
        {"periods": [{k: pad(v) for k, v in d.items()}
                     for d in states["periods"]],
         "tail": [{k: pad(v) for k, v in d.items()} for d in states["tail"]]}


@pytest.fixture(scope="module", params=ARCHS)
def model_case(request, mesh):
    """Both packages' logits, loss, prefill and one decode step on the same
    parameters and batch, for one smoke config."""
    arch = request.param
    ref_cfg, cfg = smoke(arch, ref_configs), smoke(arch, configs)
    rng = np.random.default_rng(ARCHS.index(arch))
    batch = _batch(cfg, rng)
    ref = ref_build_model(ref_cfg, mesh)
    ref_params, _ = ref.init(jax.random.key(1))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(to_numpy(ref_params), "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: to_torch(v) for k, v in batch.items()}
    out = {}
    for name, pkg, m, p, b in (("ref", jnp, ref, ref_params, jb),
                               ("port", torch, model, params, tb)):
        h, _, _ = m._stack(p, m._embed_inputs(p, b))
        last, states = m.prefill(p, {k: v for k, v in b.items()
                                     if k != "labels"})
        n_prompt = S + (cfg.n_patches if cfg.frontend == "vision_stub"
                        else 0)
        caches = _pad_caches(states, n_prompt + EXTRA, pkg)
        tok = b["tokens"][:, -1:]
        if pkg is jnp:
            step = m.decode_step(p, tok, caches,
                                 jnp.full((B,), n_prompt, jnp.int32))
        else:
            step = m.decode_step(p, tok, caches,
                                 torch.full((B,), n_prompt))
        out[name] = {"logits": m.logits(p, h), "loss": m.loss(p, b)[0],
                     "prefill": (last, states), "decode": step}
    return out


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


@pytest.mark.parametrize("what", ["logits", "loss", "prefill", "decode"])
def test_model_matches_reference(model_case, what):
    """Logits (the padded vocab rows at -1e30), the masked loss, prefill's
    last logits and its per-block caches, and one decode step's logits and
    caches: qwen3-4b (qk-norm, GQA), starcoder2-3b (2 KV heads),
    internvl2-76b (vision-stub patches before the tokens) and qwen3-4b with
    alternating global and windowed blocks."""
    got, want = _leaves(model_case["port"][what]), \
        _leaves(model_case["ref"][what])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        close(g, w)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-4b-local"])
def test_decode_matches_forward(arch):
    """Twin of the reference's test: teacher-forced decode logits equal
    the full forward's at every position (the port alone; its forward is
    held against the reference above)."""
    cfg = smoke(arch, configs)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))[0]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, S)))
    h, _, _ = model._stack(params, model._embed_inputs(params,
                                                       {"tokens": toks}))
    full = model.logits(params, h)
    spec = model.cache_spec(B, S)[0]
    caches = {part: [{k: torch.zeros(t.shape, dtype=t.dtype)
                      for k, t in d.items()} for d in spec[part]]
              for part in ("periods", "tail")}
    errs = []
    for t in range(S):
        lg, caches = model.decode_step(params, toks[:, t:t + 1], caches,
                                       torch.full((B,), t))
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, max(errs)


def test_local_attention_window():
    """Twin of the reference's test: a token more than ``window`` away does
    not reach the last position's logits, and reaches the first's."""
    cfg = dataclasses.replace(configs.smoke_config("recurrentgemma-2b"),
                              block_pattern=("local",), n_layers=1, window=4)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))[0]
    t1 = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(1, 12)))
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 7) % cfg.vocab
    outs = []
    for tk in (t1, t2):
        h, _, _ = model._stack(params, model._embed_inputs(
            params, {"tokens": tk}))
        outs.append(model.logits(params, h))
    torch.testing.assert_close(outs[0][:, -1], outs[1][:, -1], rtol=0,
                               atol=1e-5)
    assert float((outs[0][:, 0] - outs[1][:, 0]).abs().max()) > 1e-4


def test_input_specs_and_cache_spec_match_reference(mesh):
    """Shapes of every input of a decode cell and of the caches, as the
    reference's ShapeDtypeStructs give them."""
    cfg = smoke("qwen3-4b-local", configs)
    shape = configs.ShapeConfig("tiny", "decode", 64, 2)
    got = input_specs(cfg, shape)[0]
    want, _ = ref_input_specs(smoke("qwen3-4b-local", ref_configs), shape,
                              mesh)
    assert [tuple(t.shape) for t in _leaves(got)] == \
        [tuple(t.shape) for t in _leaves(want)]
    assert all(t.device.type == "meta" for t in _leaves(got))
