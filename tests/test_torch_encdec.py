"""The PyTorch port's encoder–decoder (whisper-base, audio-stub frames) ≡
the JAX package, at its smoke config on the CPU.

Frames and tokens are drawn with numpy from a seed; parameters come from
the reference's ``init`` through ``params_from_numpy``, and the
reference's calls run under ``jax.jit``.  Everything is float32 with
rtol = atol = 1e-5 (``TOL``), except decode against forward: 2e-4, the
reference's own test's bound.
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
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.encdec import EncDecModel  # noqa: E402

from _torch_model_cases import (B, S, assert_case, batch_of,  # noqa: E402
                                close, decode_errors, run_case, spec_shapes,
                                to_numpy, to_torch, zero_caches)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


def decoder_logits(model, params, batch):
    """The decoder's logits at every position, the padded vocab rows at
    -1e30 (either package's model)."""
    lay = layers if isinstance(model, EncDecModel) else ref_layers
    enc = model.encode(params, batch["frames"])
    x = lay.embed_lookup(params["embed"], batch["tokens"])
    x, _ = model._dec_stack(params, x, enc)
    return model._mask(lay.unembed(x, params["embed"]))


@pytest.fixture(scope="module")
def model_case(mesh):
    return run_case(ARCH, mesh, 40, decoder_logits)


@pytest.mark.parametrize("what", ["logits", "loss", "prefill", "decode"])
def test_model_matches_reference(model_case, what):
    """Decoder logits over bidirectionally encoded frames, the loss,
    prefill's last logits and caches (self-attention K/V over the tokens,
    cross-attention K/V over the frames, stacked over the layers) and one
    decode step against them."""
    assert_case(model_case, what)


def test_decode_matches_forward():
    """Twin of the reference's test: teacher-forced decode logits equal
    the decoder's forward at every position (2e-4), with the
    cross-attention K/V of the forward's encoding in the caches."""
    cfg = configs.smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))[0]
    batch = {k: torch.from_numpy(v) for k, v in
             batch_of(cfg, np.random.default_rng(3)).items()}
    full = decoder_logits(model, params, batch)
    enc = model.encode(params, batch["frames"])
    _, fwd = model._dec_stack(
        params, layers.embed_lookup(params["embed"], batch["tokens"]), enc)
    caches = zero_caches(model, S)
    caches["xk"], caches["xv"] = fwd["xk"], fwd["xv"]
    err = decode_errors(model, params, batch["tokens"], full, caches)
    assert err < 2e-4, err


def test_input_specs_and_init_match_reference(mesh):
    """The frames, tokens and labels of a train cell (frames in bf16), the
    caches of a decode cell (shapes and dtypes), and the port's ``init``
    tree, against the reference's."""
    cfg, ref_cfg = configs.smoke_config(ARCH), ref_configs.smoke_config(ARCH)
    shape = configs.ShapeConfig("tiny", "train", 24, 2)
    got = input_specs(cfg, shape)[0]
    want, _ = ref_input_specs(ref_cfg, shape, mesh)
    assert list(got) == list(want)
    assert [s for s, _ in spec_shapes(got)] == \
        [s for s, _ in spec_shapes(want)]
    assert got["frames"].dtype == torch.bfloat16
    shape = configs.ShapeConfig("tiny", "decode", 24, 2)
    got = input_specs(cfg, shape)[0]["caches"]
    want, _ = ref_input_specs(ref_cfg, shape, mesh)
    assert spec_shapes(got) == spec_shapes(want["caches"])
    want = jax.eval_shape(lambda k: ref_build_model(ref_cfg, mesh).init(k)[0],
                          jax.random.key(0))
    got = build_model(cfg, device="cpu").init(torch.Generator())[0]
    assert spec_shapes(got) == spec_shapes(want)


def test_encoder_matches_reference(mesh):
    """The encoder alone: bidirectional self-attention over the frames (a
    frame early in the sequence sees the last one)."""
    ref_cfg = ref_configs.smoke_config(ARCH)
    ref = ref_build_model(ref_cfg, mesh)
    ref_params, _ = ref.init(jax.random.key(2))
    model = build_model(configs.smoke_config(ARCH), device="cpu")
    params = params_from_numpy(to_numpy(ref_params), "cpu")
    frames = np.random.default_rng(2).normal(
        size=(B, ref_cfg.encoder_frames, ref_cfg.d_model)).astype(np.float32)
    want = jax.jit(ref.encode)(ref_params, jnp.asarray(frames))
    got = model.encode(params, to_torch(frames))
    close(got, want)
    later = frames.copy()
    later[:, -1] += 1.0
    moved = model.encode(params, to_torch(later))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4
