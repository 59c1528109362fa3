"""The port's verify path on the CPU (tendermint_tpu_torch.ops.ed25519_torch)
against the JAX package's (tendermint_tpu.ops.ed25519_jax) and the pure
ZIP-215 reference: prepared rows byte for byte, the fixed-base table, the
decompression and the verdicts on the adversarial gauntlet.  The one JAX
batch here has 36 rows, a bucket (64) the JAX package's own tests
compile."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tendermint_tpu.crypto import ed25519 as jref  # noqa: E402
from tendermint_tpu.ops import ed25519_jax as jdev  # noqa: E402
from tendermint_tpu.ops import host_prep as jhost  # noqa: E402
from tendermint_tpu_torch import convert, testkit  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ref  # noqa: E402
from tendermint_tpu_torch.crypto.batch import new_batch_verifier  # noqa: E402
from tendermint_tpu_torch.crypto.keys import PrivKey  # noqa: E402
from tendermint_tpu_torch.ops import ed25519_torch as dev  # noqa: E402
from tendermint_tpu_torch.ops import kernels  # noqa: E402


@pytest.fixture(scope="module")
def gauntlet():
    cases = testkit.adversarial_cases(seed=0)
    return [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases]


def test_prepare_batch_rows_match_jax(gauntlet, monkeypatch):
    pubs, msgs, sigs = gauntlet
    port = dev.prepare_batch(pubs, msgs, sigs)
    # the JAX package's hashlib path, which the port copies, fills k only
    # for valid rows; its native kernel hashes every row
    monkeypatch.setattr(jhost, "batch_k_native", lambda *a, **kw: None)
    jax_rows = jdev.prepare_batch(pubs, msgs, sigs)
    for name, p, j in zip(("pub", "r", "s", "k", "valid"), port, jax_rows):
        assert p.dtype == j.dtype and p.shape == j.shape, name
        assert np.array_equal(p, j), name
    # and the rows the kernel would trust agree with the native path too
    monkeypatch.undo()
    native = jdev.prepare_batch(pubs, msgs, sigs)
    valid = port[4]
    assert np.array_equal(valid, native[4])
    assert np.array_equal(port[3][valid], native[3][valid])
    # s == L is rejected on the host, as are bad lengths
    assert not valid.all() and valid.any()


def test_tables_from_jax_equal_port_table():
    jax_tables = jdev._core("int64")._fixed_base_tables
    assert np.array_equal(convert.tables_from_jax(*jax_tables).numpy(),
                          kernels.table_from_points(ref.base_point_table()))
    # the plain version's 15-limb table is the JAX one, limb for limb
    for port, jx in zip(dev._fixed_base_tables(torch.device("cpu")), jax_tables):
        assert np.array_equal(port.numpy(), jx)


def test_verify_batch_cpu_matches_jax_and_reference(gauntlet):
    pubs, msgs, sigs = gauntlet
    assert 33 <= len(pubs) <= 64
    got = dev.verify_batch(pubs, msgs, sigs, device="cpu")
    want = [jref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)] == want
    assert list(jdev.verify_batch(pubs, msgs, sigs)) == want
    assert got.tolist() == want, [
        (i, g, w) for i, (g, w) in enumerate(zip(got.tolist(), want)) if g != w]
    assert any(want) and not all(want)
    # RFC 8032 test 1 is the last row
    assert got[-1]


def test_decompress_matches_reference():
    """Permissive decompression: every 8-torsion encoding ZIP-215 accepts
    (y >= p, x = 0 with sign 1), y = 2 off the curve, random y."""
    enc = testkit.decompress_rows(seed=2, n_random=8)
    xy, ok = dev.decompress_rows(torch.from_numpy(enc))
    for i, row in enumerate(enc):
        want = jref.decode_point_zip215(row.tobytes())
        assert (want is not None) == bool(ok[i]), i
        if want is not None:
            x = int.from_bytes(xy[i, 0].numpy().tobytes(), "little")
            y = int.from_bytes(xy[i, 1].numpy().tobytes(), "little")
            assert (x, y) == want[:2], i
    assert ok.any() and not ok.all()


def test_batch_verifiers_agree(gauntlet):
    pubs, msgs, sigs = gauntlet
    ed_rows = [i for i, p in enumerate(pubs) if len(p) == 32][:12]
    results = []
    for backend in ("torch", "cpu"):
        bv = new_batch_verifier(backend, device="cpu")
        for i in ed_rows:
            bv.add(pubs[i], msgs[i], sigs[i])
        results.append(bv.verify())
        assert bv.count() == 0
    assert results[0] == results[1]
    assert results[0][1] == [jref.verify(pubs[i], msgs[i], sigs[i]) for i in ed_rows]


def test_rfc8032_vector_1_signs_through_the_fixed_base_table():
    seed, pub, msg, sig = testkit.RFC8032_VECTOR_1
    assert ref.pubkey_from_seed(seed) == pub == jref.pubkey_from_seed(seed)
    assert ref.sign(seed, msg) == sig == jref.sign(seed, msg)
    assert PrivKey(seed).sign(msg) == sig
    # [k]B from the table equals double-and-add, for every window edge
    for k in (0, 1, 15, 16, 2**252, ref.L - 1, 2**256 - 1):
        assert ref.pt_equal(ref.scalar_mult_base(k), ref.scalar_mult(k, ref.BASE))
