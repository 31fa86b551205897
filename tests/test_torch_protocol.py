"""The PyTorch port's codec, device decode and sessions ≡ the JAX package.

Device decodes run with ``device="cpu"``: the same wave loop as on the card,
on the kernels' plain torch versions.  The reference side runs the JAX
package's pure-jnp "ref" engine, as its own CPU tests do.  Results must be
identical: the same items in the same order, hashes, sides, overflow flag
and round count; the same wire bytes.  The residual and success are held
against the reference's exact host algebra (see ``assert_same_decode``).
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.decoder import _remove_chains  # noqa: E402
from repro.core.decoder import peel as ref_peel  # noqa: E402
from repro.core.encoder import Encoder as RefEncoder  # noqa: E402
from repro.core.encoder import encode as ref_encode  # noqa: E402
from repro.core.hashing import DEFAULT_KEY  # noqa: E402
from repro.core.mapping import map_seeds  # noqa: E402
from repro.core.stream import StreamDecoder as RefStreamDecoder  # noqa: E402
from repro.core.wire import encode_frames as ref_encode_frames  # noqa: E402
from repro.kernels.ops import decode_device as ref_decode_device  # noqa: E402
from repro.kernels.ops import \
    host_symbols_to_device as ref_host_symbols_to_device  # noqa: E402
from repro.protocol import Session as RefSession  # noqa: E402
from repro.protocol import SymbolStream as RefSymbolStream  # noqa: E402
from repro.protocol import run_session as ref_run_session  # noqa: E402

from repro_torch.core import (CodedSymbols, Encoder, StreamDecoder,  # noqa: E402
                              encode, peel)
from repro_torch.core.wire import decode_frames, encode_frames  # noqa: E402
from repro_torch.kernels.ops import (decode_device,  # noqa: E402
                                     device_symbols_to_host,
                                     host_symbols_to_device)
from repro_torch.protocol import (FixedBlock, ProtocolError,  # noqa: E402
                                  ReconcileEngine, Session, SymbolStream,
                                  run_session)

ROOT = Path(__file__).resolve().parent.parent


def from_reference(sym):
    """A ``repro`` CodedSymbols (numpy arrays) as the port's CodedSymbols."""
    return CodedSymbols(sym.sums.copy(), sym.checks.copy(),
                        sym.counts.copy(), sym.nbytes)


def make_sets(rng, n_common, d_a, d_b, L):
    """Word-item sets with |A\\B| = d_a, |B\\A| = d_b (distinct items)."""
    pool = rng.integers(0, 2**32, size=(n_common + d_a + d_b, L),
                        dtype=np.uint32)
    pool[:, 0] = np.arange(pool.shape[0])
    common, ai, bi = np.split(pool, [n_common, n_common + d_a])
    return np.concatenate([common, ai]), np.concatenate([common, bi])


def diff_symbols(rng, d, L, m):
    a, b = make_sets(rng, 40, d // 2, d - d // 2, L)
    return ref_encode(a, 4 * L, m).subtract(ref_encode(b, 4 * L, m))


def assert_same_residual(got, want):
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def exact_residual(sym, res):
    """The difference symbols with ``res``'s items XOR-ed out along their
    host chains — the reference's exact host algebra."""
    exact = sym.copy()
    _remove_chains(exact, res.items, res.hashes, res.sides,
                   map_seeds(res.items, DEFAULT_KEY, sym.nbytes), DEFAULT_KEY)
    return exact


def assert_same_decode(sym, got, want):
    """Items (in order), hashes, sides, overflow and rounds equal the
    reference device engine's.  The residual and success are held against
    the reference's exact host algebra: jitted on the CPU, the reference's
    device chain can differ from its own host chain (ROADMAP, "Faults
    found"), and then its residual keeps the item it misplaced."""
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.hashes, want.hashes)
    np.testing.assert_array_equal(got.sides, want.sides)
    assert (got.overflow, got.rounds) == (want.overflow, want.rounds)
    exact = exact_residual(sym, got)
    assert_same_residual(got.residual, exact)
    assert got.success == (bool(exact.is_empty().all()) and not got.overflow)


# -------------------------------------------------- host codec layer --
@pytest.mark.parametrize("nbytes", [3, 8, 92])
def test_encoder_and_frames_match_reference(nbytes):
    rng = np.random.default_rng(nbytes)
    raw = rng.integers(0, 256, size=(300, nbytes), dtype=np.uint8)
    want = ref_encode(raw, nbytes, 200)
    got = encode(raw, nbytes, 200)
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    frame = encode_frames(got.window(50, 120), start=50, n_items=300)
    assert frame == ref_encode_frames(want.window(50, 120), start=50,
                                      n_items=300)
    back, n_items, start = decode_frames(frame)
    assert (n_items, start) == (300, 50)
    np.testing.assert_array_equal(back.counts, want.counts[50:120])


def test_device_layout_round_trip():
    sym = from_reference(diff_symbols(np.random.default_rng(1), 20, 3, 64))
    back = device_symbols_to_host(*host_symbols_to_device(sym, "cpu"),
                                  sym.nbytes)
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(back, f), getattr(sym, f))


# ------------------------------------------------------ device decode --
@pytest.mark.parametrize("L", [1, 2, 8])
@pytest.mark.parametrize("d", [0, 1, 37, 500])
def test_decode_device_matches_reference(d, L):
    """One prefix length (one jit bucket per L on the reference side)."""
    sym = diff_symbols(np.random.default_rng(10 * d + L), d, L, 1100)
    want = ref_decode_device(*ref_host_symbols_to_device(sym), nbytes=4 * L,
                             kernel="ref")
    got = decode_device(*host_symbols_to_device(from_reference(sym), "cpu"),
                        nbytes=4 * L, device="cpu")
    assert_same_decode(sym, got, want)
    assert got.success == ref_peel(sym).success
    assert got.success and got.items.shape[0] == d


def test_decode_device_overflow_matches_reference():
    sym = diff_symbols(np.random.default_rng(5), 500, 2, 1100)
    want = ref_decode_device(*ref_host_symbols_to_device(sym), nbytes=8,
                             max_diff=64, kernel="ref")
    got = decode_device(*host_symbols_to_device(from_reference(sym), "cpu"),
                        nbytes=8, max_diff=64, device="cpu")
    assert got.overflow and not got.success
    assert_same_decode(sym, got, want)
    assert_same_residual(got.residual, want.residual)


def test_peel_overflow_falls_back_to_host_and_counts_it():
    sym = from_reference(diff_symbols(np.random.default_rng(6), 120, 2, 300))
    exact = peel(sym, backend="host")
    res = peel(sym, max_diff=16, device="cpu")
    assert res.host_fallbacks == 1 and res.success
    assert {r.tobytes() for r in res.items} == \
        {r.tobytes() for r in exact.items}
    assert peel(sym, device="cpu").host_fallbacks == 0


# -------------------------------------------------- stream decoding --
def test_stream_decoder_switches_backend_mid_session():
    rng = np.random.default_rng(21)
    a, b = make_sets(rng, 200, 40, 30, 3)
    A, B = Encoder(12), Encoder(12)
    A.add_items(a)
    B.add_items(b)
    rA, rB = RefEncoder(12), RefEncoder(12)
    rA.add_items(a)
    rB.add_items(b)
    dec = StreamDecoder(12, local=B, backend="host", device="cpu")
    ref = RefStreamDecoder(12, local=rB)
    backends = ["host", "device", "host", "device", "device", "host"]
    lo, i = 0, 0
    while not dec.decoded:
        dec.backend = backends[i % len(backends)]
        hi = lo + 16
        dec.receive(A.window(lo, hi))
        ref.receive(rA.window(lo, hi))
        lo, i = hi, i + 1
    assert ref.decoded and dec.decoded_at == ref.decoded_at
    for got, want in zip(dec.result(), ref.result()):
        assert {r.tobytes() for r in got} == {r.tobytes() for r in want}
    assert dec.host_fallbacks == 0 and i > 3


# --------------------------------------------------------- sessions --
class RecordingStream:
    """A SymbolStream stand-in that records every frame it serves."""

    def __init__(self, stream):
        self.stream = stream
        self.frames_sent = []

    def frames(self, lo, hi):
        data = self.stream.frames(lo, hi)
        self.frames_sent.append(data)
        return data


@pytest.mark.parametrize("backend", ["host", "device"])
def test_session_matches_reference(backend):
    rng = np.random.default_rng(31)
    nbytes = 11
    raw = rng.integers(0, 256, size=(600, nbytes), dtype=np.uint8)
    a, b = raw[:560], np.concatenate([raw[:500], raw[560:]])
    want_stream = RecordingStream(RefSymbolStream.from_items(a, nbytes))
    rB = RefEncoder(nbytes)
    rB.add_items(b)
    want = ref_run_session(want_stream, RefSession(local=rB), wire=True)
    got_stream = RecordingStream(SymbolStream.from_items(a, nbytes))
    B = Encoder(nbytes)
    B.add_items(b)
    session = Session(local=B, backend=backend, device="cpu")
    got = run_session(got_stream, session, wire=True)
    assert got_stream.frames_sent == want_stream.frames_sent
    assert (got.symbols_used, got.symbols_received, got.bytes_received,
            got.remote_items) == (want.symbols_used, want.symbols_received,
                                  want.bytes_received, want.remote_items)
    for f in ("only_remote", "only_local"):
        assert {r.tobytes() for r in getattr(got, f)} == \
            {r.tobytes() for r in getattr(want, f)}
    assert got.only_remote.shape[0] == 60 and got.only_local.shape[0] == 40
    assert session.host_fallbacks == 0


def test_session_overflow_is_counted_and_exact():
    rng = np.random.default_rng(41)
    nbytes = 8
    raw = rng.integers(0, 256, size=(400, nbytes), dtype=np.uint8)
    a, b = raw[:380], raw[80:]
    B = Encoder(nbytes)
    B.add_items(b)
    session = Session(local=B, max_diff=16, device="cpu")
    got = run_session(SymbolStream.from_items(a, nbytes), session, wire=True)
    rB = RefEncoder(nbytes)
    rB.add_items(b)
    want = ref_run_session(RefSymbolStream.from_items(a, nbytes),
                           RefSession(local=rB), wire=True)
    assert session.host_fallbacks >= 1
    assert got.symbols_used == want.symbols_used
    for f in ("only_remote", "only_local"):
        assert {r.tobytes() for r in getattr(got, f)} == \
            {r.tobytes() for r in getattr(want, f)}


def test_session_rejects_gaps_trims_overlap():
    rng = np.random.default_rng(61)
    stream = SymbolStream.from_items(
        rng.integers(0, 256, size=(50, 16), dtype=np.uint8), 16)
    sess = Session(nbytes=16, pacing=FixedBlock(8), device="cpu")
    with pytest.raises(ProtocolError):
        sess.offer(stream.window(8, 16), 8)        # gap: nothing before it
    sess.offer(stream.window(0, 8), 0)
    sess.offer(stream.window(4, 16), 4)            # overlap: head trimmed
    assert sess.symbols_received == 16
    with pytest.raises(ProtocolError):
        sess.offer(encode(np.zeros((4, 8), np.uint8), 8, 4), 16)  # wrong ℓ


def test_session_nonconvergence_raises_and_identical_sets_settle():
    rng = np.random.default_rng(62)
    raw = rng.integers(0, 256, size=(40, 16), dtype=np.uint8)
    local = Encoder(16)
    local.add_items(raw[10:])
    sess = Session(local=local, pacing=FixedBlock(4), max_m=8, device="cpu")
    with pytest.raises(RuntimeError, match="did not converge"):
        run_session(SymbolStream.from_items(raw[:30], 16), sess)
    same = Encoder(16)
    same.add_items(raw.copy())
    rep = run_session(SymbolStream.from_items(raw, 16),
                      Session(local=same, device="cpu"))
    assert rep.only_remote.shape[0] == rep.only_local.shape[0] == 0
    assert rep.symbols_used <= 8


def test_shared_stream_syncs_three_replicas_over_wire():
    """Three replicas of different staleness sync from one SymbolStream over
    the wire on the device backend; the shared cache is extended to the
    deepest session's reach and never rebuilt."""
    rng = np.random.default_rng(63)
    state = rng.integers(0, 256, size=(3000, 16), dtype=np.uint8)
    stream = SymbolStream.from_items(state, 16)
    deepest = 0
    for lost, added in ((32, 3), (80, 5), (250, 2)):
        extra = rng.integers(0, 256, size=(added, 16), dtype=np.uint8)
        replica = Encoder(16)
        replica.add_items(np.concatenate([state[:-lost], extra]))
        session = Session(local=replica, pacing=FixedBlock(4), device="cpu")
        rep = run_session(stream, session, wire=True)
        assert {r.tobytes() for r in rep.only_remote_bytes()} == \
            {r.tobytes() for r in state[-lost:]}
        assert {r.tobytes() for r in rep.only_local_bytes()} == \
            {r.tobytes() for r in extra}
        assert 1.0 <= rep.overhead(lost + added) <= 2.0
        assert rep.remote_items == 3000 and session.host_fallbacks == 0
        deepest = max(deepest, rep.symbols_received)
    assert stream.m == deepest


def test_engine_refuses_batched_decode_it_has_not_ported():
    """Two device peers in one shape bucket, or pipelining, would need the
    batched decode (ROADMAP items 8/9): refused, never peeled on the host."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ReconcileEngine(pipeline=True)
    rng = np.random.default_rng(51)
    raw = rng.integers(0, 256, size=(100, 8), dtype=np.uint8)
    stream = SymbolStream.from_items(raw, 8)
    engine = ReconcileEngine()
    for stale in (3, 5):
        local = Encoder(8)
        local.add_items(raw[:-stale])
        engine.register(stream, Session(local=local, device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.run()


# ------------------------------------------------ isolation and device --
def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch.protocol, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_silent_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym = from_reference(diff_symbols(np.random.default_rng(2), 5, 2, 32))
    args = host_symbols_to_device(sym, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_device(*args, nbytes=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        peel(sym)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(local=Encoder(8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(local=Encoder(8), backend="host").set_backend("device")
    assert Session(local=Encoder(8), backend="auto").backend == "host"


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Run without the repository (or without CUDA), the smoke script
    exits nonzero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
