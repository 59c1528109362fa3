"""The CUDA sources' device functions, built for the CPU by the host C++
compiler (every ``csrc/*.cu``, with the headers it includes, compiles as
plain C++; the comb's tensor-core selection becomes a gather of the same
byte table there), against the plain PyTorch versions and the pure
ZIP-215 reference; and the field
multiplies and squarings per row (and per block) that the kernels' bound
is computed from (``ops/kernels.FIELD_OPS_PER_ROW``,
``FIELD_OPS_PER_BLOCK``), counted in that same code.  Integer arithmetic:
every comparison is exact; points are compared projectively."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import testkit
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.ops import ed25519_torch, fe25519, fe25519_f32, fe25519_packed, kernels

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run on one thread here.  On a few hundred rows
    their ops pass torch's parallel grain, and a pool of eight threads per
    test process, on cores that other test processes keep busy, took the
    200-row plain RLC from 1.5 s to over 100 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_build(tmp_path_factory, source: str) -> ctypes.CDLL:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("host") / f"lib{source}.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-DTM_COUNT_FIELD_OPS", "-o", str(out),
                    str(kernels.CSRC / f"{source}.cu")], check=True, timeout=300)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _host_build(tmp_path_factory, "ed25519_verify")


@pytest.fixture(scope="module")
def packed_lib(tmp_path_factory):
    return _host_build(tmp_path_factory, "ed25519_verify_packed")


@pytest.fixture(scope="module")
def f32_lib(tmp_path_factory):
    return _host_build(tmp_path_factory, "ed25519_verify_f32")


@pytest.fixture(scope="module")
def rlc_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "ed25519_rlc")
    lib.tm_host_ed25519_rlc.restype = ctypes.c_int
    lib.tm_host_rlc_fold.restype = ctypes.c_int
    return lib


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def _verify(lib, rows, impl="int64", base_mxu=False):
    """The host build of the verify kernel of (impl, base_mxu), on the
    table the card's kernel reads."""
    pub, r, s, k, valid = (np.ascontiguousarray(a) for a in rows)
    table = np.ascontiguousarray(ed25519_torch.kernel_table(impl, base_mxu, CPU).numpy())
    out = np.zeros(len(valid), dtype=np.uint8)
    getattr(lib, f"tm_host_{kernels.VERIFY_KERNELS[(impl, base_mxu)]}")(
        _p(pub), _p(r), _p(s), _p(k), _p(valid.astype(np.uint8)), _p(table), _p(out),
        ctypes.c_int(len(valid)))
    return out.astype(bool)


def _fe_ops(lib, a, b, kernel="fe_ops"):
    outs = [np.zeros_like(a) for _ in range(3)]
    getattr(lib, f"tm_host_{kernel}")(_p(a), _p(b), *map(_p, outs), ctypes.c_int(len(a)))
    return outs


def _decompress(lib, enc):
    xy = np.zeros((len(enc), 2, 32), dtype=np.uint8)
    ok = np.zeros(len(enc), dtype=np.uint8)
    lib.tm_host_decompress(_p(enc), _p(xy), _p(ok), ctypes.c_int(len(enc)))
    return xy, ok.astype(bool)


def _rlc(lib, rows):
    """The host build's (lanes uint64 [ceil(N / 64), 4, 5], prevalid)."""
    pub, r, zk, z, valid = (np.ascontiguousarray(a) for a in rows)
    n = len(valid)
    lanes = np.zeros((kernels.rlc_lanes(n), 4, 5), dtype=np.uint64)
    prevalid = np.zeros(n, dtype=np.uint8)
    assert lib.tm_host_ed25519_rlc(_p(pub), _p(r), _p(zk), _p(z), _p(valid.astype(np.uint8)),
                                   _p(lanes), _p(prevalid), ctypes.c_int(n)) == 0
    return lanes, prevalid.astype(bool)


def _fold(lib, lanes):
    work = np.zeros_like(lanes)
    width = lib.tm_host_rlc_fold(_p(np.ascontiguousarray(lanes)), _p(work), len(lanes))
    return work[:width]


def _lane_points(lanes) -> list:
    """Kernel-layout lanes (51-bit limbs) as big-int points."""
    return [tuple(sum(int(v) << (51 * i) for i, v in enumerate(coord)) % ref.P
                  for coord in lane) for lane in lanes]


def _pt_points(p) -> list:
    coords = [c.numpy() for c in p.astuple()]
    return [tuple(fe25519.int_from_limbs(c[i]) % ref.P for c in coords)
            for i in range(coords[0].shape[0])]


def _sum(points):
    total = ref.IDENTITY
    for q in points:
        total = ref.pt_add(total, q)
    return total


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


def _random_lanes(seed: int, n: int) -> np.ndarray:
    """n lanes of random multiples of B in the kernel's layout."""
    rng = np.random.default_rng(seed)
    pts = [ref.scalar_mult_base(int(rng.integers(1, 1 << 62))) for _ in range(n)]
    return np.array([[kernels.limbs51(c) for c in p] for p in pts], dtype=np.uint64)


_IMPL_OF = {name: key for key, name in kernels.VERIFY_KERNELS.items()}


@pytest.mark.parametrize("kernel", sorted(kernels.FIELD_OPS_PER_ROW))
def test_field_op_counts_per_row_match_the_kernel_source(host_lib, packed_lib, f32_lib, rlc_lib,
                                                         kernel):
    """One row of each kernel, counted; no loop depends on the data, so
    one row's count is every row's.  ed25519_rlc is counted on 1 and on
    65 rows, which fixes both its per-row and its per-block term;
    rlc_fold on 157 lanes, the commit-10k call's."""
    lib = {"51": host_lib, "packed": packed_lib, "f32": f32_lib}[kernels.layout(kernel)]
    for each in (host_lib, packed_lib, f32_lib, rlc_lib):
        _counts(each)
    if kernel in _IMPL_OF:
        pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
        rows = ed25519_torch.prepare_batch([pub], [msg], [sig])
        assert _verify(lib, rows, *_IMPL_OF[kernel]).all()
    elif kernel.startswith("fe_ops"):
        row = testkit.field_rows(seed=7, n_random=1)[:1]
        _fe_ops(lib, row, row, kernel)
    elif kernel == "decompress":
        _decompress(host_lib, testkit.decompress_rows(seed=8, n_random=0)[:1])
    elif kernel == "ed25519_rlc":
        keys = testkit.validator_keys(seed=11, n=65)
        msgs = [b"count %d" % i for i in range(65)]
        prepared = ed25519_torch.prepare_batch(
            [k.pub_key().bytes_() for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)])
        rows, _ = testkit.rlc_rows(prepared, seed=12)
        for n in (1, 65):
            _rlc(rlc_lib, tuple(a[:n] for a in rows))
            assert _counts(rlc_lib) == kernels.field_ops(kernel, n), n
        return
    else:
        assert len(_fold(rlc_lib, _random_lanes(13, 157))) == 79
        assert _counts(rlc_lib) == kernels.field_ops(kernel, 157) == (78 * 9, 0)
        return
    assert _counts(lib) == kernels.FIELD_OPS_PER_ROW[kernel] == kernels.field_ops(kernel, 1)


@pytest.fixture(scope="module")
def rlc_batch():
    """200 signed votes as a mixed batch (gauntlet rows, flipped R bits,
    changed messages in every 8 rows) and as an honest batch."""
    keys = testkit.validator_keys(seed=14, n=200)
    msgs = [b"rlc vote %d" % i for i in range(200)]
    pubs = [k.pub_key().bytes_() for k in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    mixed = testkit.mixed_batch(pubs, msgs, sigs, seed=15)[:3]
    return ed25519_torch.prepare_batch(*mixed), ed25519_torch.prepare_batch(pubs, msgs, sigs)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_rlc_lane_sum_matches_the_plain_version(rlc_lib, rlc_batch, n):
    """The host build's block partition (one lane per 64 rows) sums to the
    plain version's lanes (the JAX program's partition), prevalid is the
    same and so is the equation's decision; on the honest rows it holds,
    on the mixed ones (from 2 rows up) it does not."""
    for prepared, honest in zip(rlc_batch, (False, True)):
        rows, c_row = testkit.rlc_rows(tuple(a[:n] for a in prepared), seed=16 + n)
        lanes, prevalid = _rlc(rlc_lib, rows)
        plain, plain_prevalid = ed25519_torch.verify_core_rlc(*map(torch.from_numpy, rows))
        assert np.array_equal(prevalid, plain_prevalid.numpy())
        assert ref.pt_equal(_sum(_lane_points(lanes)), _sum(_pt_points(plain)))
        decision = ed25519_torch.finalize_rlc(plain, c_row)
        as_pt = ed25519_torch.lanes_to_pt(torch.from_numpy(lanes.astype(np.int64)))
        assert ed25519_torch.finalize_rlc(as_pt, c_row) == decision
        assert decision == (honest or n == 1)


def test_rlc_fold_matches_the_plain_fold_lane_for_lane(rlc_lib):
    """rlc_fold pairs lanes as _pt_reduce_to_lanes(acc, 128) does, so each
    folded lane is the same point, odd widths included."""
    for n in (129, 157, 300):
        lanes = _random_lanes(n, n)
        folded = _fold(rlc_lib, lanes)
        assert len(folded) == kernels.reduced_width(n, 128)
        plain = ed25519_torch._pt_reduce_to_lanes(
            ed25519_torch.lanes_to_pt(torch.from_numpy(lanes.astype(np.int64))), 128)
        assert _lane_points(folded) == _pt_points(plain)
        assert ref.pt_equal(_sum(_lane_points(folded)), _sum(_lane_points(lanes)))
    few = _random_lanes(1, 5)
    assert np.array_equal(_fold(rlc_lib, few), few)


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


@pytest.fixture(scope="module")
def libs(host_lib, packed_lib, f32_lib):
    return {"int64": host_lib, "packed": packed_lib, "f32": f32_lib}


@pytest.mark.parametrize("impl,base_mxu", sorted(kernels.VERIFY_KERNELS))
def test_every_verify_kernel_matches_the_reference(libs, impl, base_mxu):
    """Each layout's kernel, and the comb, on the gauntlet and on a mixed
    batch of signed votes: the reference's verdicts."""
    cases = testkit.adversarial_cases(seed=0)
    keys = testkit.validator_keys(seed=17, n=40)
    msgs = [b"layout vote %d" % i for i in range(40)]
    mixed = testkit.mixed_batch([k.pub_key().bytes_() for k in keys], msgs,
                                [k.sign(m) for k, m in zip(keys, msgs)], seed=18)
    for pubs, msgs, sigs in (tuple([c[i] for c in cases] for i in range(3)), mixed[:3]):
        want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
        got = _verify(libs[impl], ed25519_torch.prepare_batch(pubs, msgs, sigs), impl, base_mxu)
        assert got.tolist() == want
        assert any(want) and not all(want)


@pytest.mark.parametrize("module,lib_name", [(fe25519_packed, "packed"), (fe25519_f32, "f32")])
def test_layout_fe_ops_match_their_plain_versions(libs, module, lib_name):
    """fe_ops_packed and fe_ops_f32 on random values, the field's edge
    values and the layouts' edge values: the plain versions' bytes."""
    a = np.concatenate([testkit.field_rows(seed=19, n_random=48), testkit.layout_edge_rows()])
    b = np.ascontiguousarray(np.roll(a, 7, axis=0))
    want = module.fe_ops(torch.from_numpy(a), torch.from_numpy(b))
    for got, w in zip(_fe_ops(libs[lib_name], a, b, f"fe_ops_{lib_name}"), want):
        assert np.array_equal(got, w.numpy())


def test_comb_selection_matches_the_plain_one_hot_product(host_lib):
    """The host build's comb_select (the gather that stands in for the
    tensor cores) on every digit in every window and on random rows: the
    plain one-hot product, and the entries [j * 256^w]B themselves."""
    table = kernels.comb_table(CPU)
    every = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 32, axis=1)
    rand = np.random.default_rng(20).integers(0, 256, size=(40, 32), dtype=np.uint8)
    outs = []
    for s in (every, rand):
        out = np.zeros((len(s), 32, 128), dtype=np.uint8)
        host_lib.tm_host_comb_select(_p(np.ascontiguousarray(s)), _p(table.numpy()), _p(out),
                                     ctypes.c_int(len(s)))
        assert np.array_equal(out, ed25519_torch.comb_select_plain(torch.from_numpy(s),
                                                                   table).numpy())
        outs.append(out)
    rows = ref.base_point_table256()
    for w, j in ((0, 1), (1, 255), (31, 128), (17, 0)):
        entry = b"".join((c % ref.P).to_bytes(32, "little") for c in rows[w][j])
        assert outs[0][j, w].tobytes() == entry
