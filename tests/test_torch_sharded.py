"""The PyTorch port's batched decode, sharded serving and multi-peer engine
≡ the JAX package.

Device decodes run with ``device="cpu"``: the same wave loop as on the
card, on the kernels' plain torch versions.  Results are held bit for bit
(items, order, hashes, sides, overflow, wire bytes) against the reference
where one run of it is cheap — its batched decode pays a jit compile per
shape bucket, its host backend pays none — and against the port's own
per-unit ``decode_device`` elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.decoder import _remove_chains  # noqa: E402
from repro.core.encoder import Encoder as RefEncoder  # noqa: E402
from repro.core.hashing import DEFAULT_KEY  # noqa: E402
from repro.core.mapping import map_seeds  # noqa: E402
from repro.core.wire import (decode_shard_frames as ref_decode_shard,  # noqa: E402
                             encode_shard_frames as ref_encode_shard)
from repro.kernels.ops import \
    decode_device_batched as ref_decode_batched  # noqa: E402
from repro.protocol import ReconcileEngine as RefEngine  # noqa: E402
from repro.protocol import ShardedSession as RefShardedSession  # noqa: E402
from repro.protocol import ShardedStream as RefShardedStream  # noqa: E402
from repro.protocol import run_sharded_session as ref_run_sharded  # noqa: E402
from repro.protocol import shard_of as ref_shard_of  # noqa: E402

from repro_torch.core import CodedSymbols, Encoder, kmax  # noqa: E402
from repro_torch.core.wire import (decode_shard_frames,  # noqa: E402
                                   encode_frames, encode_shard_frames)
from repro_torch.kernels import ops, peel  # noqa: E402
from repro_torch.kernels.ops import (decode_device,  # noqa: E402
                                     decode_device_batched,
                                     decode_device_batched_start,
                                     host_symbols_to_device)
from repro_torch.protocol import (FixedBlock, ProtocolError,  # noqa: E402
                                  ReconcileEngine, Session, ShardedSession,
                                  ShardedStream, SymbolStream, run_session,
                                  run_sharded_session, serve, shard_of)


def rand_items(rng, n, nbytes, tag=None):
    out = rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)
    if tag is not None:
        out[:, 0] = tag
    return out


def as_set(rows):
    return {r.tobytes() for r in rows}


def port_sym(sym):
    return CodedSymbols(sym.sums.copy(), sym.checks.copy(),
                        sym.counts.copy(), sym.nbytes)


def diff_units(rng, ds, m, L=2, shared=None):
    """One reference difference per d in ``ds`` at prefix m (m may be a
    list); ``shared`` words go stale in every unit, so each unit recovers
    them too."""
    ms = m if isinstance(m, list) else [m] * len(ds)
    out = []
    for d, mu in zip(ds, ms):
        items = rng.integers(0, 2**32, size=(200, L), dtype=np.uint32)
        A, B = RefEncoder(4 * L), RefEncoder(4 * L)
        A.add_items(items)
        B.add_items(items[d:])
        if shared is not None:
            A.add_items(shared)
        out.append(A.symbols(mu).subtract(B.symbols(mu)))
    return out


# ------------------------------------------------------ RSH1 and shard_of --
def test_rsh1_bytes_equal_reference():
    rng = np.random.default_rng(500)
    enc, renc = Encoder(8), RefEncoder(8)
    items = rand_items(rng, 200, 8)
    enc.add_items(items)
    renc.add_items(items)
    frames = [(0, encode_frames(enc.window(0, 16), start=0, n_items=200)),
              (3, encode_frames(enc.window(16, 50), start=16, n_items=200))]
    payload = encode_shard_frames(frames, n_shards=4)
    assert payload == ref_encode_shard(frames, 4)
    n_shards, out = decode_shard_frames(payload)
    (rn, rout) = ref_decode_shard(payload)
    assert n_shards == rn == 4 and len(out) == len(rout) == 2
    for (sid, sym, n_items, start), (rsid, rsym, rn_items, rstart) in \
            zip(out, rout):
        assert (sid, n_items, start) == (rsid, rn_items, rstart)
        for f in ("sums", "checks", "counts"):
            np.testing.assert_array_equal(getattr(sym, f), getattr(rsym, f))
    assert decode_shard_frames(encode_shard_frames([], 4)) == (4, [])


def test_rsh1_rejects_garbage():
    frame = encode_frames(Encoder(8).window(0, 4), n_items=0)
    with pytest.raises(ValueError, match="magic"):
        decode_shard_frames(b"XXXX" + b"\x00" * 16)
    with pytest.raises(ValueError, match="truncated"):
        decode_shard_frames(b"")
    with pytest.raises(ValueError, match="truncated"):
        decode_shard_frames(encode_shard_frames([(0, frame)], 2)[:-5])
    with pytest.raises(ValueError, match="shard_id"):
        encode_shard_frames([(2, frame)], 2)
    with pytest.raises(ValueError):
        encode_shard_frames([(0, frame)], 0)
    bad = bytearray(encode_shard_frames([(1, frame)], 2))
    bad[8:10] = (9).to_bytes(2, "little")
    with pytest.raises(ValueError, match="shard_id"):
        decode_shard_frames(bytes(bad))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_of_equals_reference(n_shards):
    rng = np.random.default_rng(510 + n_shards)
    items = rand_items(rng, 700, 11)
    for key in (DEFAULT_KEY, (123, 456)):
        want = ref_shard_of(items, n_shards, key=key, nbytes=11)
        np.testing.assert_array_equal(
            shard_of(items, n_shards, key=key, nbytes=11), want)
    stream = ShardedStream.from_items(items, 11, n_shards=n_shards)
    ref = RefShardedStream.from_items(items, 11, n_shards=n_shards)
    assert [s.n_items for s in stream.shards] == \
        [s.n_items for s in ref.shards]
    reqs = [(s, 0, 9) for s in range(n_shards)]
    assert stream.payload(reqs) == ref.payload(reqs)


# ---------------------------------------------------------- batched decode --
def test_decode_device_batched_matches_reference():
    """One small batch (one reference jit bucket): three units of ragged
    prefix length, one tripping max_diff, padded to four units.  Items,
    order, hashes, sides, overflow and rounds are the reference's; the
    residual and success follow its exact host algebra (its jitted chain
    can differ from its host chain; ROADMAP, "Faults found")."""
    rng = np.random.default_rng(520)
    units = diff_units(rng, [3, 9, 30], [90, 150, 200])
    kw = dict(nbytes=8, max_diff=12, pad_units=4)
    want = ref_decode_batched(units, **kw)
    got = decode_device_batched([port_sym(u) for u in units], device="cpu",
                                **kw)
    assert [g.overflow for g in got] == [False, False, True]
    for sym, g, w in zip(units, got, want):
        np.testing.assert_array_equal(g.items, w.items)
        np.testing.assert_array_equal(g.hashes, w.hashes)
        np.testing.assert_array_equal(g.sides, w.sides)
        assert (g.overflow, g.rounds) == (w.overflow, w.rounds)
        exact = sym.copy()
        _remove_chains(exact, g.items, g.hashes, g.sides,
                       map_seeds(g.items, DEFAULT_KEY, 8), DEFAULT_KEY)
        for f in ("sums", "checks", "counts"):
            np.testing.assert_array_equal(getattr(g.residual, f),
                                          getattr(exact, f))
        assert g.success == (bool(exact.is_empty().all()) and not g.overflow)


def _assert_units_decode_alone(units, got, D, mp):
    for sym, g in zip(units, got):
        if sym.m == 0:
            assert g.success and g.items.shape[0] == 0
            continue
        alone = decode_device(*host_symbols_to_device(sym, "cpu"), nbytes=8,
                              max_diff=D, block_m=mp, device="cpu")
        for f in ("items", "hashes", "sides"):
            np.testing.assert_array_equal(getattr(g, f), getattr(alone, f))
        assert (g.success, g.overflow) == (alone.success, alone.overflow)
        for f in ("sums", "checks", "counts"):
            np.testing.assert_array_equal(getattr(g.residual, f),
                                          getattr(alone.residual, f))
        assert g.rounds >= alone.rounds


def test_decode_device_batched_equals_per_unit_decodes():
    """Each unit of a batch decodes exactly as it would alone at the same
    mp, K and max_diff: a unit that overflows alone, two units that
    recover the same items, an empty unit, padding."""
    rng = np.random.default_rng(530)
    shared = rng.integers(0, 2**32, size=(4, 2), dtype=np.uint32)
    units = [port_sym(u) for u in diff_units(rng, [5, 40, 5, 0], 240,
                                             shared=shared)]
    units.append(CodedSymbols.zeros(0, 8))
    got = decode_device_batched(units, nbytes=8, max_diff=24, pad_units=8,
                                device="cpu")
    assert len(got) == 5
    assert [g.overflow for g in got] == [False, True, False, False, False]
    _assert_units_decode_alone(units, got, 24, 256)
    # the shared stale items came back in both units that peeled them
    for u in (0, 2):
        assert as_set(shared) <= as_set(got[u].items)
    assert got[3].success and got[3].items.shape[0] == 4


def test_decode_device_batched_caps_each_unit_alone():
    """Six units whose first waves together hold more pure rows than the
    per-unit cap (256): each unit still takes its own first cap rows."""
    rng = np.random.default_rng(535)
    units = [port_sym(u) for u in diff_units(rng, [100] * 6, 240)]
    got = decode_device_batched(units, nbytes=8, max_diff=128, device="cpu")
    assert all(g.success for g in got)
    _assert_units_decode_alone(units, got, 128, 256)


def test_batched_start_is_ready_on_cpu_and_refuses_cuda(monkeypatch):
    rng = np.random.default_rng(540)
    units = [port_sym(u) for u in diff_units(rng, [2], 64)]
    pending = decode_device_batched_start(units, nbytes=8, device="cpu")
    assert pending.ready()
    (res,) = pending.wait()
    assert res.success and pending.wait()[0] is res
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_device_batched(units, nbytes=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedSession(n_shards=2, nbytes=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedSession(n_shards=2, nbytes=8,
                       backend="host").set_backend("device")


# ------------------------------------------------------------ wave loop --
def _decode_with_reads(units, chunk, **kw):
    """decode_device_batched_start with a wave loop that reads its stop
    flag every ``chunk`` waves: (results, the dispatch's host reads, the
    read_back waits it made)."""
    before = peel.read_back.count
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(peel, "WAVES_PER_CHUNK", chunk)
        pending = decode_device_batched_start(units, nbytes=8, device="cpu",
                                              **kw)
    got = pending.wait()
    return got, pending.host_reads, peel.read_back.count - before


def _same(a, b):
    for f in ("items", "hashes", "sides"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.success, a.overflow, a.rounds) == (b.success, b.overflow,
                                                 b.rounds)
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(a.residual, f),
                                      getattr(b.residual, f))


@pytest.mark.parametrize("chunk", [peel.WAVES_PER_CHUNK, 2, 3, 7, 50])
def test_wave_loop_chunks_change_nothing_and_bound_reads(chunk):
    """The same dispatch read back every wave and every ``chunk`` waves:
    the same items in the same order, hashes, sides, success, overflow,
    rounds and residual.  Alone, the units converge after 5, 12
    (overflowing), 3 and 8 waves, so chunks end mid-chunk for most of them
    and their later waves are no-ops; the overflowing unit freezes alone;
    a chunk of 50, longer than the whole decode, counts the same 12
    rounds.  The dispatch waits for the card at most
    ceil(waves / chunk) + 1 times, and ``host_reads`` counts exactly the
    ``read_back`` waits."""
    rng = np.random.default_rng(570)
    units = [port_sym(u) for u in diff_units(rng, [20, 90, 9, 45],
                                             [60, 130, 40, 80])]
    kw = dict(max_diff=64, pad_units=8)
    one, reads_one, waits_one = _decode_with_reads(units, 1, **kw)
    got, reads, waits = _decode_with_reads(units, chunk, **kw)
    assert [g.overflow for g in one] == [False, True, False, False]
    assert [g.success for g in one] == [True, False, True, True]
    for a, b in zip(got, one):
        _same(a, b)
    waves = one[0].rounds
    assert waves == 12 and reads_one == waits_one == waves + 1
    assert reads == waits <= -(-waves // chunk) + 1


def test_wave_loop_count_and_side_zero_forms_agree():
    """A wave's kernels A and C with ``count`` (the live items only) and
    without it (every slot, the dropped ones at side 0) give the same
    delta: the two ways the loop can leave its empty slots to the
    kernels."""
    rng = np.random.default_rng(580)
    units = [port_sym(u) for u in diff_units(rng, [30, 5], [240, 240])]
    sums, checks, counts = (torch.cat(t) for t in zip(
        *(host_symbols_to_device(u, "cpu") for u in units)))
    loop = peel.WaveLoop(sums, checks, counts.view(-1, 1), [240, 240],
                         nbytes=8, key=DEFAULT_KEY, max_diff=64,
                         K=kmax(256))
    wave = loop._stage1(loop.state)
    n = int(wave.count)
    assert 0 < n < wave.items.shape[0]
    kw = dict(K=kmax(256), m=loop.mp, nbytes=8, key=DEFAULT_KEY)
    idx_c, chk_c = peel.map_indices(wave.items, count=wave.count, **kw)
    idx_a, chk_a = peel.map_indices(wave.items, **kw)
    assert torch.equal(idx_c[:n], idx_a[:n]) and torch.equal(chk_c[:n],
                                                             chk_a[:n])
    assert torch.equal(chk_a[:n], wave.chks[:n])
    args = (wave.chks, wave.sides, wave.unit, loop.m_units)
    with_count = peel.iblt_apply(wave.items, idx_c, *args, mp=loop.mp,
                                 count=wave.count)
    every_slot = peel.iblt_apply(wave.items, idx_a, *args, mp=loop.mp)
    for a, b in zip(with_count, every_slot):
        assert torch.equal(a, b)
    assert bool(with_count[2].abs().sum() > 0)


# ------------------------------------------------------------- sessions --
def _replicas(rng, state, nbytes, stale):
    """(items, only_remote, only_local) per (lost, added) in ``stale``."""
    out = []
    for lost, added in stale:
        extra = rand_items(rng, added, nbytes, tag=9)
        out.append((np.concatenate([state[:-lost], extra]), state[-lost:],
                    extra))
    return out


def test_run_sharded_session_matches_reference():
    """Wire mode, 4 shards: the same symbols used per shard, bytes and
    recovered items as the reference's host run."""
    rng = np.random.default_rng(550)
    nbytes = 16
    state = rand_items(rng, 900, nbytes, tag=0)
    ((items, rem, loc),) = _replicas(rng, state, nbytes, [(70, 12)])
    got = run_sharded_session(
        ShardedStream.from_items(state, nbytes, n_shards=4),
        ShardedSession(local=ShardedStream.from_items(items, nbytes,
                                                      n_shards=4),
                       pacing=FixedBlock(8), device="cpu"))
    want = ref_run_sharded(
        RefShardedStream.from_items(state, nbytes, n_shards=4),
        RefShardedSession(local=RefShardedStream.from_items(items, nbytes,
                                                            n_shards=4),
                          pacing=FixedBlock(8)))
    assert (got.symbols_used, got.symbols_received, got.bytes_received,
            got.remote_items, got.grow_steps) == \
        (want.symbols_used, want.symbols_received, want.bytes_received,
         want.remote_items, want.grow_steps)
    for g, w in zip(got.shards, want.shards):
        assert (g.symbols_used, g.symbols_received) == \
            (w.symbols_used, w.symbols_received)
        assert as_set(g.only_remote) == as_set(w.only_remote)
        assert as_set(g.only_local) == as_set(w.only_local)
    assert as_set(got.only_remote_bytes()) == as_set(rem)
    assert as_set(got.only_local_bytes()) == as_set(loc)


def _engine_run(pkg, state, replicas, nbytes, pipeline, **kw):
    Stream, Engine = pkg
    stream = Stream.from_items(state, nbytes, n_shards=4)
    engine = Engine(pipeline=pipeline)
    sessions = [stream.session(
        local=Stream.from_items(items, nbytes, n_shards=4),
        pacing=FixedBlock(8), **kw) for items, _, _ in replicas]
    for s in sessions:
        engine.register(stream, s, wire=True)
    return engine, sessions, engine.run()


def test_three_peer_engine_matches_reference_and_pipeline():
    """Three stale replicas of one sharded stream, two of them stale in
    the same records, on one engine: serially, the same symbols used,
    bytes and items per shard and per peer as the reference's host run,
    one batched decode per tick; pipelined, the same symbols used."""
    rng = np.random.default_rng(560)
    nbytes = 16
    state = rand_items(rng, 1200, nbytes, tag=0)
    replicas = _replicas(rng, state, nbytes, [(60, 6), (60, 10), (90, 4)])
    port = (ShardedStream, ReconcileEngine)
    engine, sessions, got = _engine_run(port, state, replicas, nbytes,
                                        False, device="cpu")
    _, _, want = _engine_run((RefShardedStream, RefEngine), state, replicas,
                             nbytes, False)
    assert engine.dispatches == engine.ticks > 0
    for g, w, (_, rem, loc), s in zip(got, want, replicas, sessions):
        assert (g.symbols_used, g.bytes_received, g.grow_steps) == \
            (w.symbols_used, w.bytes_received, w.grow_steps)
        assert [x.symbols_used for x in g.shards] == \
            [x.symbols_used for x in w.shards]
        assert as_set(g.only_remote_bytes()) == as_set(rem)
        assert as_set(g.only_local_bytes()) == as_set(loc)
        assert s.host_fallbacks == 0
    engine, _, piped = _engine_run(port, state, replicas, nbytes, True,
                                   device="cpu")
    assert engine.dispatches == engine.ticks > 0
    for p, g in zip(piped, got):
        assert p.symbols_used == g.symbols_used
        assert [x.symbols_used for x in p.shards] == \
            [x.symbols_used for x in g.shards]
        assert p.symbols_received >= g.symbols_received
        assert as_set(p.only_remote) == as_set(g.only_remote)


def test_engine_batches_plain_peers_and_defaults_to_pipeline(monkeypatch):
    """Two plain device peers share a shape bucket: one batched decode a
    tick, never the per-unit path, and the reference's default."""
    calls = []
    real = ops.decode_device_batched_start
    monkeypatch.setattr(ops, "decode_device_batched_start",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(ops, "decode_device", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("per-unit decode_device")))
    rng = np.random.default_rng(570)
    raw = rand_items(rng, 300, 8)
    stream = SymbolStream.from_items(raw, 8)
    engine = ReconcileEngine()
    assert engine.pipeline
    for stale in (3, 5):
        local = Encoder(8)
        local.add_items(raw[:-stale])
        engine.register(stream, Session(local=local, pacing=FixedBlock(8),
                                        device="cpu"))
    reps = engine.run()
    assert [r.only_remote.shape[0] for r in reps] == [3, 5]
    assert len(calls) == engine.dispatches == engine.ticks > 0
    # the serial single-peer path keeps decode_device, as the reference
    monkeypatch.undo()
    local = Encoder(8)
    local.add_items(raw[:-4])
    rep = serve([(stream, Session(local=local, device="cpu"))],
                pipeline=False)[0]
    assert rep.only_remote.shape[0] == 4


def test_overflowed_shards_stay_pinned_and_are_counted(monkeypatch):
    """max_diff = 2 overflows every shard; each falls back to the host
    peel, stays pinned across set_backend churn, counts every host-peeled
    window, and never re-dispatches."""
    rng = np.random.default_rng(580)
    nbytes = 16
    state = rand_items(rng, 600, nbytes, tag=0)
    stream = ShardedStream.from_items(state, nbytes, n_shards=2)
    session = stream.session(
        local=ShardedStream.from_items(state[:-80], nbytes, n_shards=2),
        pacing=FixedBlock(8), max_diff=2, device="cpu")
    for _ in range(64):
        if all(u.pinned_host for u in session._shards):
            break
        session.offer_windows([(s, stream.window(s, lo, hi), lo)
                               for s, lo, hi in session.requests()])
    assert all(u.pinned_host for u in session._shards)
    pinned_at = session.host_fallbacks
    assert pinned_at >= 2
    session.set_backend("host")
    session.set_backend("device")
    assert all(u.pinned_host for u in session._shards)
    for name in ("decode_device_batched", "decode_device_batched_start"):
        monkeypatch.setattr(ops, name, lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("pinned shard re-dispatched")))
    steps = session.grow_steps
    rep = run_session(stream, session)      # dispatches on the type
    assert rep.only_remote.shape[0] == 80
    touched = session.grow_steps - steps
    assert session.host_fallbacks >= pinned_at + touched > pinned_at


def test_sharded_protocol_errors():
    rng = np.random.default_rng(590)
    nbytes = 16
    stream = ShardedStream.from_items(rand_items(rng, 200, nbytes), nbytes,
                                      n_shards=4)
    sess = ShardedSession(n_shards=8, nbytes=nbytes, device="cpu")
    with pytest.raises(ProtocolError, match="partition"):
        sess.offer_payload(stream.payload([(0, 0, 8)]))
    sess = ShardedSession(n_shards=4, nbytes=nbytes, device="cpu")
    with pytest.raises(ProtocolError, match="gap"):
        sess.offer_payload(stream.payload([(1, 8, 16)]))
    engine = ReconcileEngine()
    with pytest.raises(ProtocolError, match="partition"):
        engine.register(stream, ShardedSession(n_shards=2, nbytes=nbytes,
                                               device="cpu"))
    with pytest.raises(ProtocolError, match="ShardedSession"):
        engine.register(stream, Session(nbytes=nbytes, device="cpu"))
