"""The PyTorch port's device encoder (kernel D + ``encode_device``) ≡ the JAX
package.

The codec is integer and XOR arithmetic, so the tolerance is bit-identity.
Inputs come from numpy generators and reach both packages as the same
arrays.  The port's wrappers take their plain torch path here because the
tensors lie on the CPU (``chip_smoke.py`` holds the CUDA kernel against
it on the card); the reference's Pallas kernel runs in interpret mode, as
its own CPU tests run it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.decoder import peel as ref_peel  # noqa: E402
from repro.core.encoder import encode as ref_encode  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels.iblt_encode import iblt_encode as pallas_encode  # noqa: E402
from repro.kernels.ops import encode_device as ref_encode_device  # noqa: E402

from repro_torch.core import encode, kmax  # noqa: E402
from repro_torch.core.hashing import DEFAULT_KEY  # noqa: E402
from repro_torch.kernels.iblt_encode import iblt_encode  # noqa: E402
from repro_torch.kernels.map_indices import map_indices  # noqa: E402
from repro_torch.kernels.ops import (decode_device,  # noqa: E402
                                     device_symbols_to_host, encode_device)


def rand_words(rng, n, L):
    w = rng.integers(0, 2**32, size=(n, L), dtype=np.uint32)
    w[:, 0] = np.arange(n, dtype=np.uint32)      # distinct items
    return w


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def assert_symbols_equal(got, want):
    """Port (sums, checks, counts) tensors ≡ reference arrays, bit for bit."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype).reshape(w.shape),
                                      w)


# ------------------------------------------------------- kernel twins --
@pytest.mark.parametrize("L", [1, 2, 8])
def test_iblt_encode_ref_matches_reference(L):
    """Chains at K = kmax(m) with pads (idx = m), plus slots past m set by
    hand: only 0 <= idx < m counts."""
    rng = np.random.default_rng(400 + L)
    n, m = 90, 300
    items = rand_words(rng, n, L)
    idx, chk = map_indices(t32(items), K=kmax(m), m=m, nbytes=4 * L,
                           key=DEFAULT_KEY)
    idx[::7, -1] = m + 5
    want = ref_kernels.iblt_encode_ref(jnp.asarray(items),
                                       jnp.asarray(idx.numpy()),
                                       jnp.asarray(u32(chk)), m=m)
    got = iblt_encode(t32(items), idx, chk, m=m)
    assert all(g.dtype == torch.int32 for g in got)
    assert [tuple(g.shape) for g in got] == [(m, L), (m, 2), (m, 1)]
    assert_symbols_equal(got, want)


def test_iblt_encode_matches_pallas_kernel():
    """The Pallas kernel in interpret mode, a 2 × 2 grid of 64-blocks."""
    rng = np.random.default_rng(410)
    n, m, L = 128, 128, 2
    items = rand_words(rng, n, L)
    idx, chk = map_indices(t32(items), K=12, m=m, nbytes=8, key=DEFAULT_KEY)
    want = pallas_encode(jnp.asarray(items), jnp.asarray(idx.numpy()),
                         jnp.asarray(u32(chk)), m=m, block_m=64, block_n=64,
                         interpret=True)
    assert_symbols_equal(iblt_encode(t32(items), idx, chk, m=m), want)


# ------------------------------------------------------ encode_device --
@pytest.mark.parametrize("L,n,m", [(1, 300, 128), (2, 100, 64),
                                   (8, 77, 512)])
def test_encode_device_matches_reference_and_host(L, n, m):
    """n = 100 and 77 are ragged against the reference's 64-item blocks."""
    rng = np.random.default_rng(420 + L)
    items = rand_words(rng, n, L)
    got = encode_device(items, m=m, nbytes=4 * L, block_n=64, block_m=64,
                        device="cpu")
    assert [g.device.type for g in got] == ["cpu"] * 3
    want = ref_encode_device(jnp.asarray(items), m=m, nbytes=4 * L,
                             block_n=64, block_m=64, interpret=True,
                             mapping="ref")
    assert_symbols_equal(got, want)
    host = encode(items, 4 * L, m)
    assert host.checks.dtype == np.uint64
    dev = device_symbols_to_host(*got, 4 * L)
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(dev, f), getattr(host, f))


def test_encode_device_padded_equals_unpadded():
    """The reference's regression: a block size that needs pad rows and
    one that does not give the same symbols (K = 8 truncates both alike);
    in the port neither pads, and both equal the reference's."""
    items = rand_words(np.random.default_rng(430), 96, 2)
    kw = dict(m=64, nbytes=8, K=8, block_m=64)
    padded = encode_device(items, block_n=64, device="cpu", **kw)
    unpadded = encode_device(items, block_n=32, device="cpu", **kw)
    for a, b in zip(padded, unpadded):
        assert torch.equal(a, b)
    want = ref_encode_device(jnp.asarray(items), block_n=64, interpret=True,
                             mapping="ref", **kw)
    assert_symbols_equal(padded, want)


def test_encode_subtract_decode_matches_reference():
    """Encode A and B on the device, subtract there, wave-peel: the
    difference symbols equal the reference's host encoders', and the
    decode recovers exactly what the reference's peel recovers."""
    rng = np.random.default_rng(440)
    L, m = 2, 256
    pool = rand_words(rng, 260, L)
    a, b = pool[:230], np.concatenate([pool[:200], pool[230:]])
    sa, ca, na = encode_device(a, m=m, device="cpu")
    sb, cb, nb = encode_device(b, m=m, device="cpu")
    diff = (sa ^ sb, ca ^ cb, na - nb)
    want_sym = ref_encode(a, 8, m).subtract(ref_encode(b, 8, m))
    got_sym = device_symbols_to_host(*diff, 8)
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(got_sym, f),
                                      getattr(want_sym, f))
    res = decode_device(*diff, nbytes=8, device="cpu")
    want = ref_peel(want_sym)
    assert res.success and want.success
    assert {(r.tobytes(), int(s)) for r, s in zip(res.items, res.sides)} == \
        {(r.tobytes(), int(s)) for r, s in zip(want.items, want.sides)}
    assert res.items.shape[0] == 60


def test_encode_device_refuses_cuda_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = rand_words(np.random.default_rng(450), 8, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode_device(items, m=16)
