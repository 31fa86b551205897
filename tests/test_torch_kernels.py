"""The PyTorch port's hashing, mapping and kernel twins ≡ the JAX package.

Every function here is integer/XOR arithmetic plus IEEE-rounded float32,
so the tolerance is bit-identity.  Inputs come from numpy generators and
reach both packages as the same arrays.  The CUDA kernels themselves run
only on the card (``chip_smoke.py`` holds each against these twins); here
the wrappers take their plain torch path because the tensors lie on the
CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as ref_hashing  # noqa: E402
from repro.core import mapping as ref_mapping  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels.peel import _purity_body as ref_purity_body  # noqa: E402

from repro_torch.core import hashing, mapping  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.map_indices import map_indices  # noqa: E402
from repro_torch.kernels.peel import iblt_apply, purity_scan  # noqa: E402
from repro_torch.kernels.ref import purity_ref  # noqa: E402

KEYS = [hashing.DEFAULT_KEY, (0xFFFFFFFFFFFFFFFF, 0x8000000000000001)]
# (L, nbytes): L = 1, 2, 3, 8, 23 words, with odd and non-word byte lengths
GEOMS = [(1, 3), (2, 8), (3, 11), (8, 32), (23, 92)]


def rand_words(rng, n, L, nbytes):
    """(n, L) uint32 items whose bytes past ``nbytes`` are zero."""
    w = rng.integers(0, 2**32, size=(n, L), dtype=np.uint32)
    tail = nbytes - 4 * (L - 1)
    if tail < 4:
        w[:, -1] &= np.uint32((1 << (8 * tail)) - 1)
    return w


def t32(a):
    """uint32 numpy -> int32 torch tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def u64(t):
    return t.numpy().view(np.uint64)


# ------------------------------------------------------------ hashing --
@pytest.mark.parametrize("key", KEYS, ids=["default", "high"])
@pytest.mark.parametrize("L,nbytes", GEOMS)
def test_siphash_and_seeds_match_reference(L, nbytes, key):
    rng = np.random.default_rng(L * 1000 + nbytes)
    w = rand_words(rng, 33, L, nbytes)
    want = ref_hashing.siphash24(w, key, nbytes)
    np.testing.assert_array_equal(hashing.siphash24(w, key, nbytes), want)
    np.testing.assert_array_equal(u64(hashing.siphash24_t(t32(w), key, nbytes)),
                                  want)
    hi, lo = hashing.siphash24_pair(t32(w), key, nbytes)
    rhi, rlo = ref_hashing.siphash24_pair(jnp.asarray(w), key, nbytes)
    np.testing.assert_array_equal(u32(hi), np.asarray(rhi))
    np.testing.assert_array_equal(u32(lo), np.asarray(rlo))
    seeds = ref_mapping.map_seeds(w, key, nbytes)
    np.testing.assert_array_equal(mapping.map_seeds(w, key, nbytes), seeds)
    chk, seed = common.checksum_and_seed(t32(w), key, nbytes)
    np.testing.assert_array_equal(u64(chk), want)
    np.testing.assert_array_equal(u64(seed), seeds)


def test_word_byte_helpers_match_reference():
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, size=(5, 11), dtype=np.uint8)
    w = hashing.bytes_to_words(raw, 11)
    np.testing.assert_array_equal(w, ref_hashing.bytes_to_words(raw, 11))
    np.testing.assert_array_equal(hashing.words_to_bytes(w, 11), raw)
    assert hashing.map_key((1, 2)) == ref_hashing.map_key((1, 2))


# ------------------------------------------------------------ mapping --
@pytest.mark.parametrize("m", [1, 7, 300, 1000, 160_000])
def test_indices_matrix_matches_host_chain(m):
    rng = np.random.default_rng(m)
    w = rand_words(rng, 200, 2, 8)
    seeds = ref_mapping.map_seeds(w, hashing.DEFAULT_KEY, 8)
    want = ref_mapping.indices_matrix_np(seeds, m)
    got = mapping.indices_matrix_t(torch.from_numpy(seeds.view(np.int64)), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert mapping.kmax(m) == ref_mapping.kmax(m)


def _xs64_inverse(s):
    """Inverse of the xorshift64 (13, 7, 17) step, vectorized over uint64."""
    def undo_left(y, a):
        x = y.copy()
        for _ in range(64 // a + 1):
            x = y ^ (x << np.uint64(a))
        return x

    def undo_right(y, b):
        x = y.copy()
        for _ in range(64 // b + 1):
            x = y ^ (x >> np.uint64(b))
        return x

    return undo_left(undo_right(undo_left(s, 17), 7), 13)


def _crafted_seeds(m, rng, want=24):
    """Seeds whose chain reaches an index ≥ 530,000 (< m) and whose next
    xorshift state has its top 24 bits all ones: that jump is
    ⌈(1.5 + idx)·4095⌉ > 2**31, past int32."""
    found = []
    for k in range(2, 40):
        low = rng.integers(0, 2**40, size=4096, dtype=np.uint64)
        state_k = (np.uint64(0xFFFFFF) << np.uint64(40)) | low
        seeds = state_k
        for _ in range(k):
            seeds = _xs64_inverse(seeds)
        idx = np.zeros(seeds.shape, np.int64)
        state = seeds.copy()
        for _ in range(k - 1):
            idx, state = ref_mapping._jump_np(idx, state)
        hit = (idx >= 530_000) & (idx < m)
        found.extend(seeds[hit][:4])
        if len(found) >= want:
            break
    seeds = np.asarray(found[:want], np.uint64)
    assert seeds.size == want
    return seeds


def test_indices_matrix_past_int32_jump():
    """m ≥ 10⁶ with crafted xorshift states: the jump overflows int32, the
    host chain ends at m, and the port must end there too (the reference's
    jnp chain wraps negative instead)."""
    m = 2**21
    rng = np.random.default_rng(11)
    seeds = _crafted_seeds(m, rng)
    want = ref_mapping.indices_matrix_np(seeds, m)
    got = mapping.indices_matrix_t(torch.from_numpy(seeds.view(np.int64)), m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >= 0).all() and (got.numpy()[:, -1] == m).all()
    # the single step at a large index, against the host step
    idx = np.full(seeds.shape, 600_000, np.int64)
    n_idx, n_state = ref_mapping._jump_np(idx, seeds)
    t_idx, t_state = mapping._jump_t(torch.from_numpy(idx),
                                     torch.from_numpy(seeds.view(np.int64)))
    np.testing.assert_array_equal(t_idx.numpy(), n_idx)
    np.testing.assert_array_equal(u64(t_state), n_state)


def test_chain_matches_host_where_reference_jit_differs():
    """An item whose 13th mapped index is 230 on the host chain.  The
    reference's jnp chain, jitted on the CPU, gives 229 (ROADMAP, "Faults
    found"); the port's chain must give the host's 230."""
    x = np.array([[176, 1679119631]], np.uint32)
    host = ref_mapping.indices_matrix_np(
        ref_mapping.map_seeds(x, hashing.DEFAULT_KEY, 8), 1100, 20)
    assert host[0, 12] == 230
    idx, _ = map_indices(t32(x), K=20, m=1100, nbytes=8,
                         key=hashing.DEFAULT_KEY)
    np.testing.assert_array_equal(idx.numpy(), host)


# ------------------------------------------------------- kernel twins --
@pytest.mark.parametrize("L,nbytes", [(1, 3), (3, 11), (8, 32)])
def test_map_indices_matches_reference(L, nbytes):
    rng = np.random.default_rng(L)
    w = rand_words(rng, 48, L, nbytes)
    K, m = 10, 300
    ri, rc = ref_kernels.map_indices_ref(jnp.asarray(w), K=K, m=m,
                                         nbytes=nbytes, key=KEYS[1])
    idx, chk = map_indices(t32(w), K=K, m=m, nbytes=nbytes, key=KEYS[1])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(u32(chk), np.asarray(rc))


def _symbols(rng, mp, L, nbytes, n_pure):
    """Random residual symbols with ``n_pure`` planted pure ones (both
    signs) and a zero tail."""
    sums = rand_words(rng, mp, L, nbytes)
    checks = rng.integers(0, 2**32, size=(mp, 2), dtype=np.uint32)
    counts = rng.integers(-3, 4, size=(mp, 1)).astype(np.int32)
    rows = rng.choice(mp - 20, size=n_pure, replace=False)
    h = ref_hashing.siphash24(sums[rows], hashing.DEFAULT_KEY, nbytes)
    checks[rows, 0] = (h >> np.uint64(32)).astype(np.uint32)
    checks[rows, 1] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    counts[rows, 0] = rng.choice([-1, 1, 2, -2], size=n_pure)
    counts[rows[:3], 0] = 0           # a matching checksum alone is not pure
    sums[-20:], checks[-20:], counts[-20:] = 0, 0, 0
    return sums, checks, counts, rows


@pytest.mark.parametrize("L,nbytes", [(1, 3), (3, 11), (8, 32)])
def test_purity_matches_reference(L, nbytes):
    rng = np.random.default_rng(100 + L)
    mp = 300                                  # not a multiple of 256
    sums, checks, counts, rows = _symbols(rng, mp, L, nbytes, 40)
    want = np.asarray(ref_purity_body(
        jnp.asarray(sums), jnp.asarray(checks), jnp.asarray(counts),
        key=hashing.DEFAULT_KEY, nbytes=nbytes))
    got = purity_scan(t32(sums), t32(checks), torch.from_numpy(counts),
                      key=hashing.DEFAULT_KEY, nbytes=nbytes)
    assert got.dtype == torch.int32 and got.shape == (mp,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[rows[3:]] != 0).all() and (want[rows[:3]] == 0).all()
    np.testing.assert_array_equal(
        purity_ref(t32(sums), t32(checks), torch.from_numpy(counts),
                     key=hashing.DEFAULT_KEY, nbytes=nbytes).numpy(), want)


def _apply_inputs(rng, n, L, nbytes, m, m_out):
    items = rand_words(rng, n, L, nbytes)
    idx, chk = map_indices(t32(items), K=mapping.kmax(m_out), m=m,
                           nbytes=nbytes, key=hashing.DEFAULT_KEY)
    sides = rng.choice([-1, 0, 1], size=n).astype(np.int32)
    return items, idx, chk, sides


@pytest.mark.parametrize("L,nbytes", [(1, 3), (3, 11), (8, 32)])
def test_iblt_apply_matches_reference(L, nbytes):
    """Rows with side 0 carry pad indices (idx = m), the convention of the
    reference's peel stage; rows [m, m_out) stay zero."""
    rng = np.random.default_rng(200 + L)
    m, m_out = 300, 512
    items, idx, chk, sides = _apply_inputs(rng, 60, L, nbytes, m, m_out)
    idx[torch.from_numpy(sides == 0)] = m
    want = ref_kernels.iblt_apply_ref(
        jnp.asarray(items), jnp.asarray(idx.numpy()),
        jnp.asarray(u32(chk)), jnp.asarray(sides), m=m, m_out=m_out)
    got = iblt_apply(t32(items), idx, chk, torch.from_numpy(sides), m=m,
                     m_out=m_out)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    assert all((g[m:] == 0).all() for g in got)


def test_iblt_apply_side_zero_rows_contribute_nothing():
    """A side-0 row is disabled outright, even with valid indices (the
    reference's docstring contract; its code still XORs such rows)."""
    rng = np.random.default_rng(300)
    m = 300
    items, idx, chk, sides = _apply_inputs(rng, 60, 3, 11, m, m)
    live = torch.from_numpy(sides != 0)
    full = iblt_apply(t32(items), idx, chk, torch.from_numpy(sides), m=m)
    part = iblt_apply(t32(items)[live], idx[live], chk[live],
                      torch.from_numpy(sides)[live], m=m)
    for a, b in zip(full, part):
        assert torch.equal(a, b)
