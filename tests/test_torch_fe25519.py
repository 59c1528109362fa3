"""The port's plain field and point layer (tendermint_tpu_torch.ops.fe25519)
against the JAX package's (tendermint_tpu.ops.fe25519) on the same
seeded inputs.  Everything is integer arithmetic, so every comparison is
exact: canonical limbs equal, and equal to big-int math."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tendermint_tpu.ops import fe25519 as jfe  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ref  # noqa: E402
from tendermint_tpu_torch.ops import fe25519 as tfe  # noqa: E402
from tendermint_tpu_torch import testkit  # noqa: E402

P = ref.P
# every JAX-side input has ROWS rows, so the eager JAX programs compiled
# for one test serve the next
ROWS = 16


def _limb_rows(ints):
    return np.stack([tfe.limbs_from_int(v) for v in ints])


def _random_ints(seed):
    """ROWS 255-bit values: the field's edge values, then random ones."""
    rng = np.random.default_rng(seed)
    edges = testkit.field_edge_values()
    return edges + [int.from_bytes(rng.bytes(32), "little") & ((1 << 255) - 1)
                    for _ in range(ROWS - len(edges))]


def _canon_port(t):
    return tfe.fe_canonical(t).numpy()


def _canon_jax(a):
    return np.asarray(jfe.fe_canonical(a))


def _both(fn_name, *args):
    """(port canonical limbs, JAX canonical limbs) of fe25519.<fn_name>."""
    port = getattr(tfe, fn_name)(*(torch.tensor(a) for a in args))
    jx = getattr(jfe, fn_name)(*(jnp.asarray(a) for a in args))
    return _canon_port(port), _canon_jax(jx)


def test_field_ops_match_jax_and_bigint():
    a_ints = _random_ints(11)
    b_ints = list(reversed(_random_ints(12)))
    a, b = _limb_rows(a_ints), _limb_rows(b_ints)
    # fe_sub needs a reduced subtrahend and fe_neg limbs < 2^19: carried inputs
    b_red = np.asarray(jfe.fe_carry(jnp.asarray(b)))
    cases = {
        "fe_mul": ((a, b), lambda x, y: x * y),
        "fe_sq": ((a,), lambda x: x * x),
        "fe_add": ((a, b), lambda x, y: x + y),
        "fe_sub": ((a, b_red), lambda x, y: x - y),
        "fe_neg": ((b_red,), lambda y: -y),
        "fe_carry": ((a,), lambda x: x),
    }
    for name, (args, want_fn) in cases.items():
        port, jx = _both(name, *args)
        assert np.array_equal(port, jx), name
        for i in range(len(a_ints)):
            vals = [tfe.int_from_limbs(arg[i]) for arg in args]
            assert tfe.int_from_limbs(port[i]) == want_fn(*vals) % P, (name, i)
    # raw limbs agree too: the same columns, carried the same way
    assert np.array_equal(tfe.fe_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                          np.asarray(jfe.fe_mul(jnp.asarray(a), jnp.asarray(b))))


def test_pow_p58_eq_is_zero_match_jax():
    a_ints = _random_ints(13)
    a = _limb_rows(a_ints)
    port, jx = _both("fe_pow_p58", a)
    assert np.array_equal(port, jx)
    for i, v in enumerate(a_ints):
        assert tfe.int_from_limbs(port[i]) == pow(v, (P - 5) // 8, P)
    # p and 0 are the same element; p + 1 and 1 too
    x = _limb_rows([0, P, 1, P + 1, 5] + a_ints[5:])
    y = _limb_rows([P, 0, P + 1, 1, 6] + a_ints[5:])
    got = tfe.fe_eq(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.tolist() == np.asarray(jfe.fe_eq(jnp.asarray(x), jnp.asarray(y))).tolist()
    assert got.tolist() == [True, True, True, True, False] + [True] * (ROWS - 5)
    zero = tfe.fe_is_zero(torch.from_numpy(x)).numpy()
    assert zero.tolist() == np.asarray(jfe.fe_is_zero(jnp.asarray(x))).tolist()
    assert zero[:5].tolist() == [True, True, False, False, False]


def test_fe_canonical_edge_patterns_match_jax():
    """Any bounded limb pattern — wide unreduced limbs, values just above
    and below p — freezes to the same canonical limbs in both packages."""
    rng = np.random.default_rng(99)
    edges = _limb_rows(testkit.field_edge_values())
    n = ROWS - len(edges)
    pats = rng.integers(0, 1 << 40, size=(n, tfe.NLIMBS), dtype=np.int64) >> rng.integers(
        0, 36, size=(n, 1))
    pats = np.concatenate([edges, pats])
    port = _canon_port(torch.from_numpy(pats))
    assert np.array_equal(port, _canon_jax(jnp.asarray(pats)))
    for row, out in zip(pats, port):
        assert tfe.int_from_limbs(out) == tfe.int_from_limbs(row) % P
        assert out.max() < (1 << tfe.LIMB_BITS)


def test_carry_stress_at_worst_case_bounds():
    """fe_mul/fe_sq at the worst representable inputs (limbs at the pt_dbl
    F-bound, ~722k) and random limbs < 2^19: reduced outputs (< 2^18) that
    agree with the JAX package and with big-int math — the int64 >> of the
    plain version behaves as jnp's."""
    rng = np.random.default_rng(7)
    worst = np.full((ROWS, tfe.NLIMBS), 722_000, dtype=np.int64)
    rand = rng.integers(0, 1 << 19, size=(ROWS, tfe.NLIMBS), dtype=np.int64)
    for a in (worst, rand):
        for b in (worst, rand):
            got = tfe.fe_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            assert got.max() < (1 << 18)
            assert np.array_equal(got, np.asarray(jfe.fe_mul(jnp.asarray(a), jnp.asarray(b))))
            for ra, rb, rg in zip(a, b, _canon_port(torch.from_numpy(got))):
                assert tfe.int_from_limbs(rg) == tfe.int_from_limbs(ra) * tfe.int_from_limbs(rb) % P
        got = tfe.fe_sq(torch.from_numpy(a)).numpy()
        assert got.max() < (1 << 18)
        assert np.array_equal(got, np.asarray(jfe.fe_sq(jnp.asarray(a))))


def _points():
    """ROWS points as big-int extended coordinates: random multiples of
    B, then every 8-torsion point (the identity among them)."""
    rng = np.random.default_rng(5)
    torsion = ref.eight_torsion_points()
    pts = [ref.scalar_mult_base(int.from_bytes(rng.bytes(32), "little") % ref.L)
           for _ in range(ROWS - len(torsion))]
    return pts + torsion


def _as_pt(module, lib, pts):
    coords = [np.stack([tfe.limbs_from_int(p[c]) for p in pts]) for c in range(4)]
    return module.Pt(*(lib(c) for c in coords))


def _affine(coords_canon, i):
    x, y, z = (tfe.int_from_limbs(c[i]) for c in coords_canon[:3])
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_point_ops_match_jax_and_reference():
    pts = _points()
    rev = pts[::-1]
    tp, tq = _as_pt(tfe, torch.from_numpy, pts), _as_pt(tfe, torch.from_numpy, rev)
    jp, jq = _as_pt(jfe, jnp.asarray, pts), _as_pt(jfe, jnp.asarray, rev)
    bits = np.arange(len(pts)) % 2
    cases = [
        ("pt_add", tfe.pt_add(tp, tq), jfe.pt_add(jp, jq),
         [ref.pt_add(p, q) for p, q in zip(pts, rev)]),
        ("pt_dbl", tfe.pt_dbl(tp), jfe.pt_dbl(jp), [ref.pt_double(p) for p in pts]),
        ("pt_dbl_n", tfe.pt_dbl_n(tp, 3), jfe.pt_dbl_n(jp, 3),
         [ref.scalar_mult(8, p) for p in pts]),
        ("pt_neg", tfe.pt_neg(tp), jfe.pt_neg(jp), [ref.pt_neg(p) for p in pts]),
        ("pt_select", tfe.pt_select(torch.from_numpy(bits), tp, tq),
         jfe.pt_select(jnp.asarray(bits), jp, jq),
         [p if b else q for b, p, q in zip(bits, pts, rev)]),
    ]
    for name, port, jx, want in cases:
        pc = [_canon_port(c) for c in port.astuple()]
        jc = [_canon_jax(c) for c in jx.astuple()]
        for c_port, c_jax in zip(pc, jc):
            assert np.array_equal(c_port, c_jax), name
        for i, w in enumerate(want):
            assert _affine(pc, i) == _affine([np.stack([tfe.limbs_from_int(v)]) for v in w], 0), (
                name, i)
    ident = tfe.pt_is_identity(tfe.pt_dbl_n(tp, 3)).numpy()
    assert ident.tolist() == np.asarray(jfe.pt_is_identity(jfe.pt_dbl_n(jp, 3))).tolist()
    # [8]T is the identity exactly for the torsion points and the identity
    assert ident.tolist() == [False] * (ROWS - 8) + [True] * 8


def test_fe_ops_plain_matches_bigint():
    """The plain version of the fe_ops kernel (bytes in, canonical bytes
    out) on random and edge values, including non-canonical inputs >= p."""
    rows = testkit.field_rows(3, 24)
    b_rows = np.roll(rows, 5, axis=0).copy()
    mul, sq, p58 = tfe.fe_ops_rows(torch.from_numpy(rows), torch.from_numpy(b_rows))
    for i in range(len(rows)):
        a = int.from_bytes(rows[i].tobytes(), "little")
        b = int.from_bytes(b_rows[i].tobytes(), "little")
        assert int.from_bytes(mul[i].numpy().tobytes(), "little") == a * b % P
        assert int.from_bytes(sq[i].numpy().tobytes(), "little") == a * a % P
        assert int.from_bytes(p58[i].numpy().tobytes(), "little") == pow(a, (P - 5) // 8, P)
