"""The port's RLC batch equation (tendermint_tpu_torch.ops.ed25519_torch:
verify_core_rlc, prepare_rlc_scalars, finalize_rlc, verify_batch_rlc) on
the CPU, against the JAX package's and the pure ZIP-215 reference.

The one JAX program here is ``_compiled_rlc(16, "int64", 2048)``, the
bucket ``tests/test_rlc.py`` compiles too, called from one test only:
lane-for-lane parity of the plain version with it, the lanes' sum of
every RLC kernel's host build (``csrc/ed25519_rlc.cuh`` built by g++)
against its lanes' sum, and verdict parity of ``verify_batch_rlc`` on
batches that pass at that bucket.  Every other case (fallbacks, torsion
and non-canonical vectors, other sizes) is held against the reference
only, so no second JAX program is compiled.  Integer arithmetic and
boolean verdicts: every comparison is exact, field values canonical mod
p."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tendermint_tpu.crypto import ed25519 as jref  # noqa: E402
from tendermint_tpu.ops import ed25519_jax as jdev  # noqa: E402
from tendermint_tpu.ops import fe25519 as jfe  # noqa: E402
from tendermint_tpu_torch import testkit  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ref  # noqa: E402
from tendermint_tpu_torch.crypto.batch import TorchBatchVerifier  # noqa: E402
from tendermint_tpu_torch.crypto.keys import PrivKey  # noqa: E402
from tendermint_tpu_torch.ops import ed25519_torch as dev  # noqa: E402
from tendermint_tpu_torch.ops import fe25519 as fe  # noqa: E402
from tendermint_tpu_torch.ops import kernels  # noqa: E402
from tests import test_torch_kernel_host as host  # noqa: E402
from tests.test_torch_kernel_host import rlc_lib  # noqa: E402, F401  (the RLC host builds)

BUCKET = 16


def _signed(n: int, first_seed: int, tag: bytes):
    keys = [PrivKey(bytes([first_seed + i]) * 32) for i in range(n)]
    msgs = [tag + b"-%d" % i for i in range(n)]
    return [k.pub_key().bytes_() for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)]


@pytest.fixture(scope="module")
def batch():
    """The 12-row batch of tests/test_rlc.py (keys from seeds 1..12)."""
    return _signed(12, 1, b"rlc-msg")


def _adversarial(batch):
    """The 12 rows with an off-curve R in row 2 and a small-order key in
    row 5."""
    pubs, msgs, sigs = (list(x) for x in batch)
    sigs[2] = (2).to_bytes(32, "little") + sigs[2][32:]
    pubs[5] = ref.encode_point(ref.eight_torsion_points()[3])
    return pubs, msgs, sigs


def _points(coords) -> list:
    """Canonical (X, Y, Z, T) of every lane of 15 x 17-bit limb arrays."""
    coords = [np.asarray(c) for c in coords]
    return [tuple(fe.int_from_limbs(c[i]) % ref.P for c in coords)
            for i in range(coords[0].shape[0])]


def _sum(points):
    total = ref.IDENTITY
    for p in points:
        total = ref.pt_add(total, p)
    return total


def _excluded(batch):
    """s = L in row 3 and a malformed length in row 7: both False on the
    host, z = 0, and the batch still passes (tests/test_rlc.py)."""
    pubs, msgs, sigs = (list(x) for x in batch)
    sigs[3] = sigs[3][:32] + ref.L.to_bytes(32, "little")
    sigs[7] = sigs[7][:40]
    return pubs, msgs, sigs


def test_plain_version_matches_jax_lanes_and_verdicts(batch, rlc_lib, monkeypatch):
    """All comparisons with the JAX program sit in this one test, so that
    the program is compiled in one worker process only.

    Lanes: the plain version on the 16 rows the JAX program sees (the
    honest batch, and one with an off-curve R and a small-order key),
    lane for lane against ``_compiled_rlc(16, "int64", 2048)``, with the
    same prevalid and the same decision; each RLC kernel's host build (64
    window lanes) with the same lanes' sum and prevalid.  Verdicts: ``verify_batch_rlc``
    against the JAX one on the batches that pass at bucket 16 (honest,
    and with s = L and a bad length), with RLC_STATS moving the same way."""
    monkeypatch.delenv("TM_TPU_RLC_LANES", raising=False)
    jax_rlc_16 = jdev._compiled_rlc(BUCKET, "int64", 2048)
    assert (jfe.NLIMBS, jfe.LIMB_BITS) == (fe.NLIMBS, fe.LIMB_BITS)  # one reader for both
    for kind, triples in (("honest", batch), ("adversarial", _adversarial(batch))):
        prepared = dev.prepare_batch(*triples)
        (pub, r, zk, z, valid), c_row = testkit.rlc_rows(prepared, seed=21)
        padded = jdev._pad_rows(len(valid), BUCKET, pub, r, zk, z, valid)
        jax_acc, jax_prevalid = jax_rlc_16(*(np.array(a) for a in padded))
        lanes, prevalid = dev.verify_core_rlc(*(torch.from_numpy(a) for a in padded))
        assert lanes.x.shape[0] == kernels.reduced_width(BUCKET, 128) == BUCKET
        assert _points(lanes.astuple()) == _points(jax_acc), kind
        assert prevalid.tolist() == np.asarray(jax_prevalid).tolist(), kind
        decision = dev.finalize_rlc(lanes, c_row)
        assert decision == jdev.finalize_rlc(jax_acc, c_row, "int64") == (kind == "honest")
        want_prevalid = [True] * 12 if kind == "honest" else [i != 2 for i in range(12)]
        assert prevalid[:12].tolist() == want_prevalid
        jax_sum = _sum(_points(jax_acc))
        for (impl, _), kernel in kernels.RLC_KERNELS.items():
            host_lanes, host_prevalid = host._rlc(rlc_lib, padded, kernel)
            assert host_prevalid.tolist() == prevalid.tolist(), (kind, kernel)
            assert ref.pt_equal(_sum(host._lane_points(host_lanes, impl)), jax_sum), (kind, kernel)
    for kind, triples in (("honest", batch), ("excluded", _excluded(batch))):
        want = [jref.verify(*t) for t in zip(*triples)]
        port_before, jax_before = dict(dev.RLC_STATS), dict(jdev.RLC_STATS)
        got = dev.verify_batch_rlc(*triples, device="cpu")
        jax_got = jdev.verify_batch_rlc(*triples, impl="int64")
        assert got.tolist() == jax_got.tolist() == want, kind
        assert want == ([True] * 12 if kind == "honest" else [i not in (3, 7) for i in range(12)])
        for stats, before in ((dev.RLC_STATS, port_before), (jdev.RLC_STATS, jax_before)):
            assert stats == {"pass": before["pass"] + 1, "fallback": before["fallback"]}, kind


def _reference(pubs, msgs, sigs):
    return [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


def test_corrupted_signature_falls_back_exact(batch):
    pubs, msgs, sigs = (list(x) for x in batch)
    sigs[5] = sigs[5][:-1] + bytes([sigs[5][-1] ^ 1])
    before = dict(dev.RLC_STATS)
    got = dev.verify_batch_rlc(pubs, msgs, sigs, device="cpu")
    assert got.tolist() == _reference(pubs, msgs, sigs) == [i != 5 for i in range(12)]
    assert dev.RLC_STATS == {"pass": before["pass"], "fallback": before["fallback"] + 1}


def test_zip215_edge_vectors_match_reference():
    """Torsion-component keys and non-canonical encodings of R (the
    vectors of tests/test_rlc.py): the [8] after [c]B must cancel the
    torsion parts, and whatever fails goes to the exact fallback."""
    priv = PrivKey(b"\x07" * 32)
    pub, msg = priv.pub_key().bytes_(), b"edge"
    pubs, msgs, sigs = [pub], [msg], [priv.sign(msg)]
    for t in ref.eight_torsion_points():
        pubs.append(ref.encode_point(t))
        msgs.append(b"torsion")
        sigs.append(b"\x01" * 32 + (5).to_bytes(32, "little"))
    small = ref.eight_torsion_points()[1]
    for enc in ref.noncanonical_encodings(small)[:2]:
        pubs.append(pub)
        msgs.append(b"noncanon-r")
        sigs.append(enc + (7).to_bytes(32, "little"))
    want = _reference(pubs, msgs, sigs)
    assert want == [jref.verify(*t) for t in zip(pubs, msgs, sigs)]
    assert dev.verify_batch_rlc(pubs, msgs, sigs, device="cpu").tolist() == want


def test_small_order_key_and_r_pass_the_equation():
    """Small-order A and R with s = 0 are valid under ZIP-215; their
    terms cancel only after the final [8], and the batch passes without
    a fallback."""
    pubs, msgs, sigs = _signed(3, 40, b"mix")
    for t in ref.eight_torsion_points()[:4]:
        enc = ref.encode_point(t)
        pubs.append(enc)
        msgs.append(b"any")
        sigs.append(enc + bytes(32))
    assert all(_reference(pubs, msgs, sigs))
    before = dict(dev.RLC_STATS)
    assert dev.verify_batch_rlc(pubs, msgs, sigs, device="cpu").all()
    assert dev.RLC_STATS["pass"] == before["pass"] + 1
    assert dev.RLC_STATS["fallback"] == before["fallback"]


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9])
def test_small_and_odd_sizes(n):
    pubs, msgs, sigs = _signed(n, 31, b"odd")
    before = dict(dev.RLC_STATS)
    assert dev.verify_batch_rlc(pubs, msgs, sigs, device="cpu").tolist() == [True] * n
    assert dev.RLC_STATS["pass"] == before["pass"] + 1


def test_empty_batch():
    assert dev.verify_batch_rlc([], [], [], device="cpu").tolist() == []


def test_prepare_rlc_scalars_excludes_invalid_rows_and_never_draws_zero(batch, monkeypatch):
    pubs, msgs, sigs = _excluded(batch)
    pub_rows, r_rows, s_rows, k_rows, valid = dev.prepare_batch(pubs, msgs, sigs)
    assert valid.tolist() == [i not in (3, 7) for i in range(12)]
    z_rows, zk_rows, c_row = dev.prepare_rlc_scalars(s_rows, k_rows, valid)
    assert z_rows.shape == (12, 16) and zk_rows.shape == (12, 32) and c_row.shape == (32,)
    assert z_rows[valid].any(axis=1).all() and not z_rows[~valid].any()
    c = 0
    for i in range(12):
        z = int.from_bytes(z_rows[i].tobytes(), "little")
        k = int.from_bytes(k_rows[i].tobytes(), "little")
        s = int.from_bytes(s_rows[i].tobytes(), "little")
        assert int.from_bytes(zk_rows[i].tobytes(), "little") == z * k % ref.L
        c = (c + z * s) % ref.L
    assert int.from_bytes(c_row.tobytes(), "little") == c
    # two calls draw different z (os.urandom, never a seed)
    assert not np.array_equal(dev.prepare_rlc_scalars(s_rows, k_rows, valid)[0], z_rows)
    # an all-zero draw becomes z = 1 on every row still valid
    monkeypatch.setattr(dev.os, "urandom", lambda n: bytes(n))
    z_rows, zk_rows, _ = dev.prepare_rlc_scalars(s_rows, k_rows, valid)
    assert z_rows[valid, 0].tolist() == [1] * 10 and not z_rows[:, 1:].any()
    assert not z_rows[~valid].any()
    assert np.array_equal(zk_rows[valid], k_rows[valid])


def test_seeded_rlc_rows_follow_the_same_rules(batch):
    prepared = dev.prepare_batch(*_excluded(batch))
    (pub, r, zk, z, valid), c_row = testkit.rlc_rows(prepared, seed=5)
    again, c_again = testkit.rlc_rows(prepared, seed=5)
    assert all(np.array_equal(a, b) for a, b in zip((pub, r, zk, z, valid), again))
    assert np.array_equal(c_row, c_again)
    assert z[valid].any(axis=1).all() and not z[~valid].any()


def _limb_pt(points) -> fe.Pt:
    return fe.Pt(*(torch.as_tensor(np.stack([fe.limbs_from_int(p[c]) for p in points]))
                   for c in range(4)))


def test_lane_fold_keeps_the_sum_at_odd_widths():
    """Counterpart of test_rlc.py::test_odd_width_lane_reduction_exact."""
    rng = np.random.default_rng(3)
    pts = [ref.scalar_mult(int(rng.integers(1, 1 << 30)), ref.BASE) for _ in range(7)]
    for target in (1, 2, 3):
        red = dev._pt_reduce_to_lanes(_limb_pt(pts), target)
        assert red.x.shape[0] == kernels.reduced_width(7, target) == jdev._Core._reduced_width(7, target)
        assert ref.pt_equal(_sum(_points(red.astuple())), _sum(pts)), target


@pytest.mark.parametrize("lanes", [1, 2, 3, 7])
def test_finalize_rlc_at_odd_lane_counts(lanes):
    """Lanes that sum to [-c]B plus a torsion point pass (the [8] comes
    after [c]B); one lane moved by B fails."""
    rng = np.random.default_rng(lanes)
    c = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % ref.L
    parts = [int(rng.integers(1, 1 << 62)) for _ in range(lanes - 1)]
    scalars = parts + [(-c - sum(parts)) % ref.L]
    points = [ref.scalar_mult_base(s) for s in scalars]
    points[0] = ref.pt_add(points[0], ref.eight_torsion_points()[2])
    c_row = np.frombuffer(c.to_bytes(32, "little"), dtype=np.uint8)
    assert dev.finalize_rlc(_limb_pt(points), c_row)
    points[-1] = ref.pt_add(points[-1], ref.BASE)
    assert not dev.finalize_rlc(_limb_pt(points), c_row)


def test_batch_verifier_reads_the_rlc_knob_at_every_call(batch, monkeypatch):
    pubs, msgs, sigs = batch
    bv = TorchBatchVerifier(device="cpu")
    for setting, moved in (("1", "pass"), ("0", None), ("1", "pass")):
        monkeypatch.setenv("TM_CUDA_RLC", setting)
        before = dict(dev.RLC_STATS)
        for t in zip(pubs[:4], msgs[:4], sigs[:4]):
            bv.add(*t)
        assert bv.verify() == (True, [True] * 4)
        want = dict(before)
        if moved:
            want[moved] += 1
        assert dev.RLC_STATS == want, setting


def test_verify_commit_raises_the_same_error_with_rlc_on_and_off(monkeypatch):
    keys = testkit.validator_keys(seed=12, n=10)
    vals = testkit.validator_set(keys)
    commit = testkit.signed_commit(keys, vals, height=4)
    bid = testkit.block_id_for(4)
    errors = {}
    for setting in ("0", "1"):
        monkeypatch.setenv("TM_CUDA_RLC", setting)
        vals.verify_commit(testkit.CHAIN_ID, bid, 4, commit, device="cpu")
    commit.signatures[6].signature = bytes([commit.signatures[6].signature[0] ^ 1]) + \
        commit.signatures[6].signature[1:]
    for setting in ("0", "1"):
        monkeypatch.setenv("TM_CUDA_RLC", setting)
        before = dict(dev.RLC_STATS)
        with pytest.raises(ValueError) as err:
            vals.verify_commit(testkit.CHAIN_ID, bid, 4, commit, device="cpu")
        errors[setting] = str(err.value)
        assert dev.RLC_STATS["fallback"] == before["fallback"] + (setting == "1")
    assert errors["0"] == errors["1"]
    assert "wrong signature (#6)" in errors["1"]
