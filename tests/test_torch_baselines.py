"""The PyTorch port's `Sketch`/`reconcile_sets`, baselines, density
evolution and `expected_degree` ≡ the JAX package's.

The same seeded numpy inputs go through both packages; the port's peels
run with ``device="cpu"`` (the kernels' plain torch versions).  Integer
results must be identical, floats equal to the last bit.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import de as ref_de  # noqa: E402
from repro.core import expected_degree as ref_expected_degree  # noqa: E402
from repro.core import Sketch as RefSketch  # noqa: E402
from repro.core import reconcile_sets as ref_reconcile_sets  # noqa: E402
from repro.core.baselines import CPISketch as RefCPI  # noqa: E402
from repro.core.baselines import MerkleTrieSync as RefMerkle  # noqa: E402
from repro.core.baselines import MetIBLT as RefMet  # noqa: E402
from repro.core.baselines.regular_iblt import \
    reconcile_regular as ref_reconcile_regular  # noqa: E402

from repro_torch.core import Sketch, de, expected_degree  # noqa: E402
from repro_torch.core import reconcile_sets  # noqa: E402
from repro_torch.core.baselines import (CPISketch, MerkleTrieSync,  # noqa: E402
                                        MetIBLT)
from repro_torch.core.baselines.regular_iblt import \
    reconcile_regular  # noqa: E402


def items(rng, n, nbytes=16, tag=0):
    out = rng.integers(0, 2**32, size=(n, (nbytes + 3) // 4),
                       dtype=np.uint32)
    out[:, 0] = (out[:, 0] & 0xFFFFFF00) | tag
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def rows(arr) -> set:
    return {r.tobytes() for r in arr}


def with_sides(res) -> set:
    return {(r.tobytes(), int(s)) for r, s in zip(res.items, res.sides)}


def byte_sets(rng, n_common, d_a, d_b, nbytes=32):
    common = [bytes([0]) + rng.bytes(nbytes - 1) for _ in range(n_common)]
    only_a = [bytes([1]) + rng.bytes(nbytes - 1) for _ in range(d_a)]
    only_b = [bytes([2]) + rng.bytes(nbytes - 1) for _ in range(d_b)]
    return common + only_a, common + only_b


def test_sketch_symbols_and_decode_match_reference():
    a, b = byte_sets(np.random.default_rng(0), 2_000, 30, 12)
    ref_a, ref_b = RefSketch.from_items(a, 32), RefSketch.from_items(b, 32)
    port_a, port_b = Sketch.from_items(a, 32), Sketch.from_items(b, 32)
    for m in (1, 200):
        want, got = ref_a.symbols(m), port_a.symbols(m)
        for f in ("sums", "checks", "counts"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    want = ref_b.decode_against(ref_a.symbols(200))
    got = port_b.decode_against(port_a.symbols(200), device="cpu")
    assert got.success and want.success and got.host_fallbacks == 0
    assert with_sides(got) == with_sides(want)
    assert len(with_sides(got)) == 42
    assert Sketch.from_items([], 32).m == 0


def test_reconcile_sets_matches_reference():
    a, b = byte_sets(np.random.default_rng(1), 5_000, 21, 9)
    want = ref_reconcile_sets(RefSketch.from_items(a, 32),
                              RefSketch.from_items(b, 32))
    got = reconcile_sets(Sketch.from_items(a, 32), Sketch.from_items(b, 32),
                         device="cpu")
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
    # the device peel recovers in wave order, the reference's host peel in
    # its own: the same sets
    assert rows(got[0]) == rows(want[0]) == set(a) - set(b)
    assert rows(got[1]) == rows(want[1]) == set(b) - set(a)


@pytest.mark.parametrize("n_a,n_b,m", [(12, 9, 128), (500, 1, 64)])
def test_regular_iblt_matches_reference(n_a, n_b, m):
    rng = np.random.default_rng(2)
    common = items(rng, 200)
    a = np.concatenate([common, items(rng, n_a, tag=1)])
    b = np.concatenate([common, items(rng, n_b, tag=2)])
    assert_same(reconcile_regular(a, b, m=m, nbytes=16),
                ref_reconcile_regular(a, b, m=m, nbytes=16))


def test_met_iblt_matches_reference():
    rng = np.random.default_rng(3)
    common, ai, bi = items(rng, 100), items(rng, 10, tag=1), \
        items(rng, 5, tag=2)
    tables = []
    for cls in (MetIBLT, RefMet):
        A, B = cls(m0=32, steps=4, nbytes=16), cls(m0=32, steps=4, nbytes=16)
        A.insert(np.concatenate([common, ai]))
        B.insert(np.concatenate([common, bi]))
        tables.append((A, B))
    (A, B), (RA, RB) = tables
    assert A.layout == RA.layout and A.m == RA.m
    for step in (0, 1, 3):
        got, want = A.prefix(step), RA.prefix(step)
        for f in ("sums", "checks", "counts"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert_same(A.decode(got.subtract(B.prefix(step))),
                    RA.decode(want.subtract(RB.prefix(step))))
    rec, _, ok = A.decode(A.table.subtract(B.table))
    assert ok and len(rec) == 15


@pytest.mark.parametrize("da,db", [(3, 2), (8, 0)])
def test_cpi_matches_reference(da, db):
    rng = np.random.default_rng(4)
    common, ai, bi = items(rng, 50), items(rng, da, tag=1), \
        items(rng, db, tag=2)
    m = 2 * (da + db) + 2
    out = []
    for cls in (CPISketch, RefCPI):
        A, B = cls(m, 16), cls(m, 16)
        A.insert(np.concatenate([common, ai]))
        B.insert(np.concatenate([common, bi]))
        out.append((A.evals.copy(), A.decode_against(
            B, d_bound=2 * max(da, db, 1))))
    (evals, got), (ref_evals, want) = out
    np.testing.assert_array_equal(evals, ref_evals)
    assert got == want and got[2]


def test_merkle_sync_cost_matches_reference():
    rng = np.random.default_rng(5)
    base, delta = items(rng, 2000, nbytes=20), items(rng, 20, nbytes=20,
                                                     tag=1)
    fresh = np.concatenate([base, delta])
    for other in (fresh, base):
        got = MerkleTrieSync(base, 20).sync_cost(MerkleTrieSync(other, 20),
                                                 value_bytes=72)
        want = RefMerkle(base, 20).sync_cost(RefMerkle(other, 20),
                                             value_bytes=72)
        assert got == want
    assert got == (32, 1, 0)


def test_density_evolution_and_expected_degree_match_reference():
    for y in (1e-6, 0.3, 1.0, 1.7, 25.0):
        assert de.e1(y) == ref_de.e1(y)
        assert de.ei_neg(y) == ref_de.ei_neg(y)
    q = np.array([1e-5, 0.2, 0.9])
    np.testing.assert_array_equal(de.f_limit(q, 1.4), ref_de.f_limit(q, 1.4))
    assert de.eta_star(0.5, tol=1e-3) == ref_de.eta_star(0.5, tol=1e-3)
    for eta in (1.2, 1.5):
        assert de.recovered_fraction(eta) == ref_de.recovered_fraction(eta)
    for m in (0, 1, 1_000, 123_457):
        assert expected_degree(m) == ref_expected_degree(m)
