"""The RLC batch equation of the port in every field layout
(tendermint_tpu_torch.ops.ed25519_torch: ``verify_core_rlc``,
``lanes_to_pt``, ``finalize_rlc`` and ``verify_batch_rlc`` with impl
packed and f32, with and without the matrix-unit fe_mul), the plain
versions of ``ed25519_rlc_packed``, ``ed25519_rlc_f32``,
``ed25519_rlc_f32_mma`` and the packed and f32 folds.

Each layout is held against the port's int64 plain RLC, which
tests/test_torch_rlc.py holds against the JAX ``_compiled_rlc(16,
"int64", 2048)``: the lanes are the same points lane for lane (the same
formulas on the same partition, canonical coordinates compared), with the
same prevalid and the same decision, and the whole path gives the
reference's verdicts, fallbacks included.  No JAX program is compiled
here; the f32 cases keep to 16 rows or fewer.  Every comparison is
exact."""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import testkit
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.crypto.keys import PrivKey
from tendermint_tpu_torch.ops import ed25519_torch as dev
from tendermint_tpu_torch.ops import kernels

LAYOUTS = [("packed", False), ("f32", False), ("f32", True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signed(n: int, first_seed: int, tag: bytes):
    keys = [PrivKey(bytes([first_seed + i]) * 32) for i in range(n)]
    msgs = [tag + b"-%d" % i for i in range(n)]
    return [k.pub_key().bytes_() for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)]


def _edge_vectors():
    """The ZIP-215 edge vectors of tests/test_rlc.py: an honest row, every
    8-torsion point as a key, and two non-canonical encodings of a
    small-order R (11 rows)."""
    priv = PrivKey(b"\x07" * 32)
    pub, msg = priv.pub_key().bytes_(), b"edge"
    pubs, msgs, sigs = [pub], [msg], [priv.sign(msg)]
    for t in ref.eight_torsion_points():
        pubs.append(ref.encode_point(t))
        msgs.append(b"torsion")
        sigs.append(b"\x01" * 32 + (5).to_bytes(32, "little"))
    for enc in ref.noncanonical_encodings(ref.eight_torsion_points()[1])[:2]:
        pubs.append(pub)
        msgs.append(b"noncanon-r")
        sigs.append(enc + (7).to_bytes(32, "little"))
    return pubs, msgs, sigs


def _batches():
    """(label, triples): honest rows, a bad signature, an off-curve R and
    a small-order key, small-order A and R with s = 0 (valid), the edge
    vectors; 5 to 12 rows each."""
    honest = _signed(9, 1, b"layout")
    bad = [list(x) for x in _signed(5, 20, b"bad")]
    bad[2][3] = bad[2][3][:-1] + bytes([bad[2][3][-1] ^ 1])
    odd = [list(x) for x in _signed(8, 30, b"odd")]
    odd[2][2] = (2).to_bytes(32, "little") + odd[2][2][32:]
    odd[0][5] = ref.encode_point(ref.eight_torsion_points()[3])
    small = [list(x) for x in _signed(2, 40, b"small")]
    for t in ref.eight_torsion_points()[:3]:
        enc = ref.encode_point(t)
        for col, v in zip(small, (enc, b"any", enc + bytes(32))):
            col.append(v)
    return [("honest", honest), ("bad-signature", bad), ("off-curve", odd),
            ("small-order", small), ("zip215-edges", _edge_vectors())]


@pytest.fixture(scope="module")
def int64_lanes():
    """Per batch: the RLC rows (z from a seed), c, and the int64 plain
    version's lanes as canonical bytes, prevalid and decision."""
    out = {}
    for label, triples in _batches():
        rows, c_row = testkit.rlc_rows(dev.prepare_batch(*triples), seed=31)
        tensors = tuple(torch.from_numpy(a) for a in rows)
        lanes, prevalid = dev.verify_core_rlc(*tensors)
        out[label] = (tensors, c_row, dev.pt_rows(lanes), prevalid,
                      dev.finalize_rlc(lanes, c_row))
    return out


@pytest.mark.parametrize("impl,fe_mxu", LAYOUTS)
def test_plain_rlc_lanes_match_the_int64_plain_rlc(int64_lanes, impl, fe_mxu):
    """Lane for lane the same points (canonical X, Y, Z, T), the same
    prevalid and the same decision; the kernels' lane layout reads back as
    the same point."""
    for label, (rows, c_row, want_lanes, want_prevalid, want_decision) in int64_lanes.items():
        lanes, prevalid = dev.verify_core_rlc(*rows, impl=impl, fe_mxu=fe_mxu)
        assert torch.equal(dev.pt_rows(lanes, impl), want_lanes), label
        assert torch.equal(prevalid, want_prevalid), label
        assert dev.finalize_rlc(lanes, c_row, impl) == want_decision, label
        dtype, limbs = kernels.LANE_LIMBS[impl]
        as_kernel = torch.stack(lanes.astuple(), dim=1).to(dtype)
        assert as_kernel.shape[1:] == (4, limbs)
        assert torch.equal(dev.pt_rows(dev.lanes_to_pt(as_kernel, impl), impl), want_lanes)
    decisions = {label: v[4] for label, v in int64_lanes.items()}
    assert decisions == {"honest": True, "bad-signature": False, "off-curve": False,
                         "small-order": True, "zip215-edges": False}


@pytest.mark.parametrize("impl,fe_mxu", LAYOUTS)
@pytest.mark.parametrize("n", [0, 1, 2, 5, 8, 9])
def test_verify_batch_rlc_in_each_layout_at_small_sizes(monkeypatch, impl, fe_mxu, n):
    """The whole path, ``TM_CUDA_FIELD_IMPL`` naming the layout and
    ``TM_CUDA_FE_MXU`` the multiply: honest batches pass the equation."""
    monkeypatch.setenv("TM_CUDA_FE_MXU", "1" if fe_mxu else "0")
    monkeypatch.setattr(dev, "OPTIN_STATE", {("fe_mxu", "f32", "cpu"): True})
    monkeypatch.setenv("TM_CUDA_FIELD_IMPL", impl)
    pubs, msgs, sigs = _signed(n, 50, b"sizes")
    before = dict(dev.RLC_STATS)
    assert dev.verify_batch_rlc(pubs, msgs, sigs, device="cpu").tolist() == [True] * n
    assert dev.RLC_STATS["pass"] == before["pass"] + (n > 0)
    assert dev.RLC_STATS["fallback"] == before["fallback"]


@pytest.mark.parametrize("impl,fe_mxu", LAYOUTS)
def test_fallbacks_in_each_layout_give_the_reference_verdicts(monkeypatch, impl, fe_mxu):
    """A bad signature and the ZIP-215 edge vectors fail the equation and
    go to the exact per-row path of the same layout and multiply."""
    monkeypatch.setenv("TM_CUDA_FE_MXU", "1" if fe_mxu else "0")
    monkeypatch.setattr(dev, "OPTIN_STATE", {("fe_mxu", "f32", "cpu"): True})
    for label, triples in _batches():
        if label not in ("bad-signature", "zip215-edges"):
            continue
        want = [ref.verify(*t) for t in zip(*triples)]
        before = dict(dev.RLC_STATS)
        got = dev.verify_batch_rlc(*triples, impl=impl, device="cpu")
        assert got.tolist() == want, label
        assert dev.RLC_STATS["fallback"] == before["fallback"] + 1, label


@pytest.mark.parametrize("impl", ["packed", "f32"])
def test_plain_folds_keep_each_lane_as_the_int64_fold(impl):
    """``_pt_reduce_to_lanes`` in the layout, on lanes in the kernels'
    layout at an odd width: the int64 fold's points lane for lane."""
    lanes = testkit.random_lanes(seed=33, n=131, impl=impl)
    int64 = testkit.random_lanes(seed=33, n=131)
    folded = dev._pt_reduce_to_lanes(dev.lanes_to_pt(torch.from_numpy(lanes), impl), 128, impl)
    want = dev._pt_reduce_to_lanes(dev.lanes_to_pt(torch.from_numpy(int64.astype(np.int64))), 128)
    assert folded.x.shape[0] == kernels.reduced_width(131, 128) == 66
    assert torch.equal(dev.pt_rows(folded, impl), dev.pt_rows(want))
