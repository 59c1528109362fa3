"""The CUDA source's device functions, built for the CPU by the host C++
compiler (``csrc/ed25519_verify.cu`` compiles as plain C++), against the
plain PyTorch versions and the pure ZIP-215 reference; and the field
multiplies and squarings per row that the kernels' bound is computed from
(``ops/kernels.FIELD_OPS_PER_ROW``), counted in that same code.  Integer
arithmetic: every comparison is exact."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import testkit
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.ops import ed25519_torch, fe25519, kernels


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("host") / "libtm_host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-DTM_COUNT_FIELD_OPS", "-o", str(out),
                    str(kernels.CSRC / "ed25519_verify.cu")], check=True, timeout=300)
    return ctypes.CDLL(str(out))


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def _verify(lib, rows):
    pub, r, s, k, valid = (np.ascontiguousarray(a) for a in rows)
    table = kernels.table_from_points(ref.base_point_table()).astype(np.uint64)
    out = np.zeros(len(valid), dtype=np.uint8)
    lib.tm_host_ed25519_verify(_p(pub), _p(r), _p(s), _p(k), _p(valid.astype(np.uint8)),
                               _p(table), _p(out), ctypes.c_int(len(valid)))
    return out.astype(bool)


def _fe_ops(lib, a, b):
    outs = [np.zeros_like(a) for _ in range(3)]
    lib.tm_host_fe_ops(_p(a), _p(b), *map(_p, outs), ctypes.c_int(len(a)))
    return outs


def _decompress(lib, enc):
    xy = np.zeros((len(enc), 2, 32), dtype=np.uint8)
    ok = np.zeros(len(enc), dtype=np.uint8)
    lib.tm_host_decompress(_p(enc), _p(xy), _p(ok), ctypes.c_int(len(enc)))
    return xy, ok.astype(bool)


def _counts(lib) -> tuple[int, int]:
    mul_sq = np.zeros(2, dtype=np.uint64)
    lib.tm_host_field_op_counts(_p(mul_sq))
    return int(mul_sq[0]), int(mul_sq[1])


def test_verify_rows_match_the_reference_on_the_gauntlet(host_lib):
    cases = testkit.adversarial_cases(seed=0)
    pubs, msgs, sigs = ([c[i] for c in cases] for i in range(3))
    got = _verify(host_lib, ed25519_torch.prepare_batch(pubs, msgs, sigs))
    want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.tolist() == want
    assert any(want) and not all(want)


def test_fe_ops_and_decompress_rows_match_the_plain_versions(host_lib):
    a = testkit.field_rows(seed=5, n_random=64)
    b = np.ascontiguousarray(np.roll(a, 3, axis=0))
    want = fe25519.fe_ops(torch.from_numpy(a), torch.from_numpy(b))
    for got, w in zip(_fe_ops(host_lib, a, b), want):
        assert np.array_equal(got, w.numpy())
    enc = testkit.decompress_rows(seed=6, n_random=64)
    xy, ok = _decompress(host_lib, enc)
    want_xy, want_ok = ed25519_torch.decompress_rows_plain(torch.from_numpy(enc))
    assert np.array_equal(ok, want_ok.numpy()) and np.array_equal(xy, want_xy.numpy())
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("kernel", sorted(kernels.FIELD_OPS_PER_ROW))
def test_field_op_counts_per_row_match_the_kernel_source(host_lib, kernel):
    """One row of each kernel, counted; no loop depends on the data, so
    one row's count is every row's."""
    _counts(host_lib)
    if kernel == "ed25519_verify":
        pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
        assert _verify(host_lib, ed25519_torch.prepare_batch([pub], [msg], [sig])).all()
    elif kernel == "fe_ops":
        row = testkit.field_rows(seed=7, n_random=1)[:1]
        _fe_ops(host_lib, row, row)
    else:
        _decompress(host_lib, testkit.decompress_rows(seed=8, n_random=0)[:1])
    assert _counts(host_lib) == kernels.FIELD_OPS_PER_ROW[kernel]


def test_verify_rows_on_a_mixed_batch(host_lib):
    """Signed votes with gauntlet rows, flipped R bits and changed
    messages spread through them: the verdicts `testkit.mixed_batch`
    expects, which are the reference's."""
    keys = testkit.validator_keys(seed=9, n=72)
    msgs = [b"vote %d" % i for i in range(72)]
    pubs, msgs, sigs, want = testkit.mixed_batch(
        [k.pub_key().bytes_() for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)],
        seed=10)
    assert [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)] == want
    got = _verify(host_lib, ed25519_torch.prepare_batch(pubs, msgs, sigs))
    assert got.tolist() == want
    assert all(any(want[i:i + 8]) and not all(want[i:i + 8]) for i in range(0, 72, 8))
