"""The port's plain f32 field and point layer
(tendermint_tpu_torch.ops.fe25519_f32, 51 signed 5-bit float32 limbs)
against the JAX package's (tendermint_tpu.ops.fe25519_f32, its matrix-unit
fe_mul off, as on the CPU), limb for limb, on seeded inputs: random
values, the layouts' edge values, and signed limbs at each bound of the
JAX module's ledger; called eagerly, never through a compiled f32 verify
program.  Every intermediate is an integer below 2^24, exact in float32:
every comparison is exact."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tendermint_tpu.ops import fe25519_f32 as jfe  # noqa: E402
from tendermint_tpu_torch import testkit  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ref  # noqa: E402
from tendermint_tpu_torch.ops import fe25519_f32 as tfe  # noqa: E402

P = ref.P
ROWS = 16  # every JAX-side input has ROWS rows, so one test's eager programs serve the next


def _ints(seed):
    """ROWS 255-bit values: the layouts' edge values, then random ones."""
    rng = np.random.default_rng(seed)
    edges = testkit.layout_edge_values()
    return edges + [int.from_bytes(rng.bytes(32), "little") % (1 << 255)
                    for _ in range(ROWS - len(edges))]


def _limbs(ints):
    return np.stack([tfe.limbs_from_int(v) for v in ints])


def _port(name, *args, **kw):
    return getattr(tfe, name)(*(torch.from_numpy(a) for a in args), **kw).numpy()


def _jax(name, *args, **kw):
    return np.asarray(getattr(jfe, name)(*(jnp.asarray(a) for a in args), **kw))


def _value(limbs) -> int:
    return tfe.int_from_limbs(limbs) % P


def test_layout_and_constants_match_jax():
    assert (tfe.NLIMBS, tfe.LIMB_BITS) == (jfe.NLIMBS, jfe.LIMB_BITS)
    for v in _ints(1) + [P]:
        assert np.array_equal(tfe.limbs_from_int(v), jfe.limbs_from_int(v))
    for name, jname in (("V4P", "_V4P"), ("D", "D_CONST"), ("D2", "D2_CONST"),
                        ("SQRT_M1", "SQRT_M1_CONST"), ("ONE", "ONE")):
        assert np.array_equal(tfe.const(name, torch.device("cpu")).numpy(), getattr(jfe, jname))
    rows = np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in _ints(2)])
    got = tfe.fe_from_bytes(torch.from_numpy(rows)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, _limbs(_ints(2)))
    assert np.array_equal(tfe.fe_to_bytes(torch.from_numpy(got)).numpy(),
                          np.stack([np.frombuffer((v % P).to_bytes(32, "little"), dtype=np.uint8)
                                    for v in _ints(2)]))


def test_field_ops_match_jax_limb_for_limb():
    """Raw limbs, not only values: the same columns carried the same way."""
    a = _limbs(_ints(3))
    b = _limbs(list(reversed(_ints(4))))
    cases = {
        "fe_mul": ((a, b), {}, lambda x, y: x * y),
        "fe_sq": ((a,), {}, lambda x: x * x),
        "fe_add": ((a, b), {}, lambda x, y: x + y),
        "fe_sub": ((a, b), {}, lambda x, y: x - y),
        "fe_neg": ((a,), {}, lambda x: -x),
        "fe_carry": ((a,), {}, lambda x: x),
        "fe_canonical": ((a,), {}, lambda x: x),
        "fe_pow_p58": ((a,), {}, lambda x: pow(x, (P - 5) // 8, P)),
    }
    for name, (args, kw, want_fn) in cases.items():
        port = _port(name, *args, **kw)
        assert np.array_equal(port, _jax(name, *args, **kw)), name
        for i in range(ROWS):
            assert _value(port[i]) == want_fn(*(_value(x[i]) for x in args)) % P, (name, i)
    x = _limbs([0, P, 1, P + 1, 5] + _ints(5)[5:])
    y = _limbs([P, 0, P + 1, 1, 6] + _ints(5)[5:])
    for name in ("fe_eq", "fe_is_zero"):
        args = (x, y) if name == "fe_eq" else (x,)
        assert _port(name, *args).tolist() == _jax(name, *args).tolist()
    assert _port("fe_eq", x, y).tolist() == [True] * 4 + [False] + [True] * (ROWS - 5)


def _signed(rng, bound, first=None):
    """ROWS x 51 signed limbs in [-bound, bound]; rows 0 and 1 at +bound
    and -bound (or `first`)."""
    a = rng.integers(-bound, bound + 1, size=(ROWS, tfe.NLIMBS)).astype(np.float32)
    a[0], a[1] = (bound, -bound) if first is None else first
    return a


def test_ops_at_the_bound_ledger_edges():
    """fe_mul at the operand contract's in-tree worst (153 x 102), fe_sq at
    |a| = 63, fe_carry at 2^24 (rounds=6) and 204 (rounds=3), fe_canonical
    on |limbs| <= 52: limbs equal to JAX's, reduced, and right in big-int."""
    rng = np.random.default_rng(6)
    a153, b102 = _signed(rng, 153), _signed(rng, 102, first=(102, 102))
    cases = [("fe_mul", (a153, b102), {}, lambda x, y: x * y),
             ("fe_sq", (_signed(rng, 63),), {}, lambda x: x * x),
             ("fe_carry", (_signed(rng, 1 << 24),), {"rounds": 6}, lambda x: x),
             ("fe_carry", (_signed(rng, 204),), {"rounds": 3}, lambda x: x),
             ("fe_canonical", (_signed(rng, 52),), {}, lambda x: x)]
    for name, args, kw, want_fn in cases:
        port = _port(name, *args, **kw)
        assert np.array_equal(port, _jax(name, *args, **kw)), (name, kw)
        assert port.min() >= -20 and port.max() <= 51, (name, port.min(), port.max())
        for i in range(ROWS):
            assert _value(port[i]) == want_fn(*(_value(x[i]) for x in args)) % P, (name, i)


def _points():
    """ROWS points: random multiples of B, then every 8-torsion point."""
    rng = np.random.default_rng(7)
    torsion = ref.eight_torsion_points()
    return [ref.scalar_mult_base(int.from_bytes(rng.bytes(32), "little") % ref.L)
            for _ in range(ROWS - len(torsion))] + torsion


def _as_pt(module, lib, pts):
    return module.Pt(*(lib(np.stack([tfe.limbs_from_int(p[c]) for p in pts])) for c in range(4)))


def _affine(coords, i):
    x, y, z = (_value(c[i]) for c in coords[:3])
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_point_ops_match_jax_on_random_and_torsion_points():
    pts = _points()
    rev = pts[::-1]
    tp, tq = _as_pt(tfe, torch.from_numpy, pts), _as_pt(tfe, torch.from_numpy, rev)
    jp, jq = _as_pt(jfe, jnp.asarray, pts), _as_pt(jfe, jnp.asarray, rev)
    bits = np.arange(ROWS) % 2
    cases = [
        ("pt_add", tfe.pt_add(tp, tq), jfe.pt_add(jp, jq), [ref.pt_add(p, q) for p, q in zip(pts, rev)]),
        ("pt_dbl", tfe.pt_dbl(tp), jfe.pt_dbl(jp), [ref.pt_double(p) for p in pts]),
        ("pt_dbl_n", tfe.pt_dbl_n(tp, 3), jfe.pt_dbl_n(jp, 3), [ref.scalar_mult(8, p) for p in pts]),
        ("pt_neg", tfe.pt_neg(tp), jfe.pt_neg(jp), [ref.pt_neg(p) for p in pts]),
        ("pt_select", tfe.pt_select(torch.from_numpy(bits), tp, tq),
         jfe.pt_select(jnp.asarray(bits), jp, jq), [p if b else q for b, p, q in zip(bits, pts, rev)]),
    ]
    for name, port, jx, want in cases:
        port = [c.numpy() for c in port.astuple()]
        for c_port, c_jax in zip(port, jx.astuple()):
            assert np.array_equal(c_port, np.asarray(c_jax)), name
        for i, w in enumerate(want):
            assert _affine(port, i) == _affine([np.stack([tfe.limbs_from_int(v)]) for v in w], 0), (
                name, i)
    ident = tfe.pt_is_identity(tfe.pt_dbl_n(tp, 3)).numpy()
    assert ident.tolist() == np.asarray(jfe.pt_is_identity(jfe.pt_dbl_n(jp, 3))).tolist()
    assert ident.tolist() == [False] * (ROWS - 8) + [True] * 8


def test_fe_ops_plain_matches_bigint():
    """The plain version of the fe_ops_f32 kernel on random values and
    on both edge sets, non-canonical inputs >= p included."""
    rows = np.concatenate([testkit.field_rows(8, 8), testkit.layout_edge_rows()])
    b_rows = np.roll(rows, 5, axis=0).copy()
    mul, sq, p58 = tfe.fe_ops_rows(torch.from_numpy(rows), torch.from_numpy(b_rows))
    for i in range(len(rows)):
        a = int.from_bytes(rows[i].tobytes(), "little")
        b = int.from_bytes(b_rows[i].tobytes(), "little")
        assert int.from_bytes(mul[i].numpy().tobytes(), "little") == a * b % P
        assert int.from_bytes(sq[i].numpy().tobytes(), "little") == a * a % P
        assert int.from_bytes(p58[i].numpy().tobytes(), "little") == pow(a, (P - 5) // 8, P)
