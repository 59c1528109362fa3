"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; on the
card run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``.
Integer arithmetic: every comparison is exact."""

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import testkit
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.ops import ed25519_torch, fe25519, fe25519_f32, fe25519_packed, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_fe_ops_kernel_matches_plain(cuda):
    a = torch.from_numpy(testkit.field_rows(seed=1, n_random=512)).to(cuda)
    b = a.roll(7, dims=0).contiguous()
    before = kernels.LAUNCHES["fe_ops"]
    got = fe25519.fe_ops_rows(a, b)
    want = fe25519.fe_ops(a, b)
    assert kernels.LAUNCHES["fe_ops"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_decompress_kernel_matches_plain(cuda):
    enc = torch.from_numpy(testkit.decompress_rows(seed=2, n_random=512)).to(cuda)
    xy, ok = ed25519_torch.decompress_rows(enc)
    want_xy, want_ok = ed25519_torch.decompress_rows_plain(enc)
    assert torch.equal(ok, want_ok) and torch.equal(xy, want_xy)
    assert ok.any() and not ok.all()


def test_verify_kernel_matches_plain_and_reference(cuda):
    cases = testkit.adversarial_cases(seed=0)
    pubs, msgs, sigs = ([c[i] for c in cases] for i in range(3))
    rows = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(pubs, msgs, sigs), cuda)
    before = kernels.LAUNCHES["ed25519_verify"]
    got = ed25519_torch.verify_rows(*rows)
    assert kernels.LAUNCHES["ed25519_verify"] == before + 1
    want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.cpu().tolist() == want
    assert ed25519_torch.verify_core(*rows).cpu().tolist() == want
    assert ed25519_torch.verify_batch(pubs, msgs, sigs).tolist() == want


def test_verify_kernel_matches_plain_on_a_mixed_batch_across_blocks(cuda):
    keys = testkit.validator_keys(seed=4, n=200)
    msgs = [b"vote %d" % i for i in range(200)]
    pubs, msgs, sigs, want = testkit.mixed_batch(
        [k.pub_key().bytes_() for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)],
        seed=5)
    rows = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(pubs, msgs, sigs), cuda)
    got = ed25519_torch.verify_rows(*rows).cpu().tolist()
    assert got == ed25519_torch.verify_core(*rows).cpu().tolist() == want


def test_verify_commit_on_the_card(cuda):
    keys = testkit.validator_keys(seed=3, n=16)
    vals = testkit.validator_set(keys)
    commit = testkit.signed_commit(keys, vals, height=7)
    # the kernel of the layout TM_CUDA_FIELD_IMPL resolves to (auto: the
    # golden gates run here, before the count)
    impl = ed25519_torch.default_impl(cuda)
    kernel = kernels.VERIFY_KERNELS[(impl, *ed25519_torch._resolve_optin(impl, cuda))]
    before = kernels.LAUNCHES[kernel]
    vals.verify_commit(testkit.CHAIN_ID, testkit.block_id_for(7), 7, commit)
    assert kernels.LAUNCHES[kernel] == before + 1
    commit.signatures[5].signature = bytes(64)
    with pytest.raises(ValueError, match=r"wrong signature \(#5\)"):
        vals.verify_commit(testkit.CHAIN_ID, testkit.block_id_for(7), 7, commit)


def test_zero_rows_and_empty_batches(cuda):
    zeros = torch.zeros((3, 32), dtype=torch.uint8, device=cuda)
    valid = torch.zeros(3, dtype=torch.bool, device=cuda)
    assert ed25519_torch.verify_rows(zeros, zeros, zeros, zeros, valid).cpu().tolist() == [False] * 3
    assert ed25519_torch.verify_batch([], [], []).shape == (0,)
    empty = torch.zeros((0, 32), dtype=torch.uint8, device=cuda)
    assert ed25519_torch.verify_rows(empty, empty, empty, empty, valid[:0]).shape == (0,)
    np.testing.assert_array_equal(
        kernels.base_table(cuda).cpu().numpy(), kernels.table_from_points(ref.base_point_table()))


def _lane_sum(lanes) -> tuple:
    """The points of a [P]-lane tensor (plain limbs), summed in big-int."""
    coords = [c.cpu().numpy() for c in lanes.astuple()]
    total = ref.IDENTITY
    for i in range(coords[0].shape[0]):
        total = ref.pt_add(total, tuple(fe25519.int_from_limbs(c[i]) % ref.P for c in coords))
    return total


def test_rlc_kernel_matches_plain_on_a_mixed_batch_across_blocks(cuda):
    keys = testkit.validator_keys(seed=6, n=200)
    msgs = [b"vote %d" % i for i in range(200)]
    pubs = [k.pub_key().bytes_() for k in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    mixed = testkit.mixed_batch(pubs, msgs, sigs, seed=7)[:3]
    for triples, honest in ((mixed, False), ((pubs, msgs, sigs), True)):
        rows, c_row = testkit.rlc_rows(ed25519_torch.prepare_batch(*triples), seed=8)
        rows = ed25519_torch.rows_to_device(rows, cuda)
        before = kernels.LAUNCHES["ed25519_rlc"]
        lanes, prevalid = kernels.ed25519_rlc(*rows)
        assert kernels.LAUNCHES["ed25519_rlc"] == before + kernels.RLC_STAGES
        assert lanes.shape == (64, 4, 5)
        plain, plain_prevalid = ed25519_torch.verify_core_rlc(*rows)
        assert torch.equal(prevalid, plain_prevalid)
        kernel_pt = ed25519_torch.lanes_to_pt(lanes)
        assert ref.pt_equal(_lane_sum(kernel_pt), _lane_sum(plain))
        assert ed25519_torch.finalize_rlc(kernel_pt, c_row) == honest
        assert ed25519_torch.finalize_rlc(plain, c_row) == honest


def test_rlc_fold_kernel_matches_plain_lane_for_lane(cuda):
    rng = np.random.default_rng(9)
    pts = [ref.scalar_mult_base(int(rng.integers(1, 1 << 62))) for _ in range(301)]
    lanes = torch.tensor([[kernels.limbs51(c) for c in p] for p in pts], device=cuda)
    before = kernels.LAUNCHES["rlc_fold"]
    folded = kernels.rlc_fold(lanes)
    assert kernels.LAUNCHES["rlc_fold"] == before + 1
    assert folded.shape == (kernels.reduced_width(301, 128), 4, 5)
    plain = ed25519_torch._pt_reduce_to_lanes(ed25519_torch.lanes_to_pt(lanes), 128)
    assert torch.equal(ed25519_torch.pt_rows(ed25519_torch.lanes_to_pt(folded)),
                       ed25519_torch.pt_rows(plain))


def test_verify_batch_rlc_on_the_card(cuda):
    cases = testkit.adversarial_cases(seed=0)
    pubs, msgs, sigs = ([c[i] for c in cases] for i in range(3))
    want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    impl = ed25519_torch.default_impl(cuda)
    base_mxu, fe_mxu = ed25519_torch._resolve_optin(impl, cuda)
    fallback = kernels.VERIFY_KERNELS[(impl, base_mxu, fe_mxu)]
    rlc = kernels.RLC_KERNELS[(impl, fe_mxu)]
    before = dict(kernels.LAUNCHES), dict(ed25519_torch.RLC_STATS)
    assert ed25519_torch.verify_batch_rlc(pubs, msgs, sigs).tolist() == want
    assert kernels.LAUNCHES[rlc] == before[0][rlc] + kernels.RLC_STAGES
    assert kernels.LAUNCHES[fallback] == before[0][fallback] + 1
    assert ed25519_torch.RLC_STATS["fallback"] == before[1]["fallback"] + 1
    honest = [i for i, ok in enumerate(want) if ok]
    got = ed25519_torch.verify_batch_rlc(*([col[i] for i in honest] for col in (pubs, msgs, sigs)))
    assert got.all() and ed25519_torch.RLC_STATS["pass"] == before[1]["pass"] + 1


# ---------------------------------------------------------------------------
# The packed and f32 layouts and the comb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,base_mxu,fe_mxu", sorted(kernels.VERIFY_KERNELS))
def test_every_verify_kernel_matches_plain_and_reference(cuda, impl, base_mxu, fe_mxu):
    """The gauntlet and a mixed batch across blocks: kernel = plain =
    reference, one launch each."""
    name = kernels.VERIFY_KERNELS[(impl, base_mxu, fe_mxu)]
    cases = testkit.adversarial_cases(seed=0)
    keys = testkit.validator_keys(seed=10, n=200)
    msgs = [b"vote %d" % i for i in range(200)]
    mixed = testkit.mixed_batch([k.pub_key().bytes_() for k in keys], msgs,
                                [k.sign(m) for k, m in zip(keys, msgs)], seed=11)
    for pubs, msgs, sigs in (([c[0] for c in cases], [c[1] for c in cases],
                              [c[2] for c in cases]), mixed[:3]):
        want = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
        rows = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(pubs, msgs, sigs), cuda)
        before = kernels.LAUNCHES[name]
        got = ed25519_torch.verify_rows(*rows, impl=impl, base_mxu=base_mxu, fe_mxu=fe_mxu)
        assert kernels.LAUNCHES[name] == before + 1
        assert got.cpu().tolist() == want
        plain = ed25519_torch.verify_core(*rows, impl=impl, base_mxu=base_mxu, fe_mxu=fe_mxu)
        assert plain.cpu().tolist() == want


@pytest.mark.parametrize("module", [fe25519_packed, fe25519_f32])
def test_layout_fe_ops_kernels_match_plain(cuda, module):
    rows = np.concatenate([testkit.field_rows(seed=12, n_random=512), testkit.layout_edge_rows()])
    a = torch.from_numpy(rows).to(cuda)
    b = a.roll(5, dims=0).contiguous()
    name = "fe_ops_packed" if module is fe25519_packed else "fe_ops_f32"
    before = kernels.LAUNCHES[name]
    got = module.fe_ops_rows(a, b)
    assert kernels.LAUNCHES[name] == before + 1
    for g, w in zip(got, module.fe_ops(a, b)):
        assert torch.equal(g, w)


def test_comb_select_kernel_covers_every_window_and_digit(cuda):
    """Row j selects digit j in every window: all 32 x 256 entries, each
    the table's bytes, as the plain one-hot product gives them."""
    s = torch.arange(256, dtype=torch.uint8, device=cuda)[:, None].expand(256, 32).contiguous()
    got = ed25519_torch.comb_select_rows(s)
    table = kernels.comb_table(cuda)
    assert torch.equal(got, table.permute(1, 0, 2))
    assert torch.equal(got, ed25519_torch.comb_select_plain(s, table))
    rng = np.random.default_rng(13)
    s = torch.from_numpy(rng.integers(0, 256, size=(77, 32), dtype=np.uint8)).to(cuda)
    assert torch.equal(ed25519_torch.comb_select_rows(s), ed25519_torch.comb_select_plain(s, table))


def test_golden_gates_pass_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(ed25519_torch, "OPTIN_STATE", {})
    assert ed25519_torch._optin_safe("impl", "packed", cuda)
    assert ed25519_torch._optin_safe("base_mxu", "int64", cuda)
    assert ed25519_torch._optin_safe("base_mxu", "f32", cuda)
    assert ed25519_torch._optin_safe("fe_mxu", "f32", cuda)
    assert ed25519_torch._optin_safe("base_mxu+fe_mxu", "f32", cuda)
    monkeypatch.delenv("TM_CUDA_FIELD_IMPL", raising=False)
    monkeypatch.delenv("TM_CUDA_FE_MXU", raising=False)
    assert ed25519_torch.default_impl(cuda) == "f32"
    monkeypatch.setenv("TM_CUDA_FE_MXU", "0")
    assert ed25519_torch.default_impl(cuda) == "packed"


@pytest.mark.parametrize("impl,mxu,fe_mxu,kernel", [
    ("packed", "0", "1", "ed25519_verify_packed"), ("f32", "0", "0", "ed25519_verify_f32"),
    ("f32", "1", "0", "ed25519_verify_f32_comb"), ("f32", "0", "1", "ed25519_verify_f32_mma"),
    ("f32", "1", "1", "ed25519_verify_f32_mma_comb"), ("int64", "1", "1", "ed25519_verify_comb"),
    ("int64", "0", "0", "ed25519_verify")])
def test_verify_commit_launches_the_chosen_kernel_once(cuda, monkeypatch, impl, mxu, fe_mxu,
                                                       kernel):
    monkeypatch.setenv("TM_CUDA_FIELD_IMPL", impl)
    monkeypatch.setenv("TM_CUDA_BASE_MXU", mxu)
    monkeypatch.setenv("TM_CUDA_FE_MXU", fe_mxu)
    keys = testkit.validator_keys(seed=3, n=16)
    vals = testkit.validator_set(keys)
    commit = testkit.signed_commit(keys, vals, height=7)
    vals.verify_commit(testkit.CHAIN_ID, testkit.block_id_for(7), 7, commit)  # gates run here
    kernels.reset_launches()
    vals.verify_commit(testkit.CHAIN_ID, testkit.block_id_for(7), 7, commit)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {kernel: 1}


# ---------------------------------------------------------------------------
# The tensor-core fe_mul and the RLC kernels of every layout
# ---------------------------------------------------------------------------

def test_fe_mul_mma_kernel_matches_the_plain_matrix_unit_product(cuda):
    """Rows at the contract's bounds and seeded ones, across blocks and a
    ragged last warp: limb for limb the plain ``fe_mul_mxu``."""
    a, b = (torch.from_numpy(x).to(cuda) for x in testkit.fe_mul_bound_limbs(seed=14, n_random=90))
    before = kernels.LAUNCHES["fe_mul_mma"]
    got = fe25519_f32.fe_mul_mxu_rows(a, b)
    assert kernels.LAUNCHES["fe_mul_mma"] == before + 1
    assert torch.equal(got, fe25519_f32.fe_mul_mxu(a.cpu(), b.cpu()).to(cuda))


@pytest.mark.parametrize("impl,fe_mxu", sorted(kernels.RLC_KERNELS))
def test_rlc_kernels_of_every_layout_match_plain(cuda, impl, fe_mxu):
    """200 rows of a mixed and an honest batch: the 64 window lanes sum to
    the plain version's, with the same prevalid and decision."""
    name = kernels.RLC_KERNELS[(impl, fe_mxu)]
    keys = testkit.validator_keys(seed=15, n=200)
    msgs = [b"layout rlc %d" % i for i in range(200)]
    pubs = [k.pub_key().bytes_() for k in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    mixed = testkit.mixed_batch(pubs, msgs, sigs, seed=16)[:3]
    for triples, honest in ((mixed, False), ((pubs, msgs, sigs), True)):
        rows, c_row = testkit.rlc_rows(ed25519_torch.prepare_batch(*triples), seed=17)
        rows = ed25519_torch.rows_to_device(rows, cuda)
        before = kernels.LAUNCHES[name]
        lanes, prevalid = kernels.rlc(impl, fe_mxu)(*rows)
        assert kernels.LAUNCHES[name] == before + kernels.RLC_STAGES
        assert lanes.shape == (64, 4, kernels.LANE_LIMBS[impl][1])
        plain, plain_prevalid = ed25519_torch.verify_core_rlc(*(t.cpu() for t in rows))
        assert torch.equal(prevalid.cpu(), plain_prevalid)
        kernel_pt = ed25519_torch.lanes_to_pt(lanes.cpu(), impl)
        got = ed25519_torch._pt_reduce_to_lanes(kernel_pt, 1, impl)
        want = ed25519_torch._pt_reduce_to_lanes(plain, 1)
        assert ref.pt_equal(_lane_sum_of(got, impl), _lane_sum(want))
        assert ed25519_torch.finalize_rlc(kernel_pt, c_row, impl) == honest


def _lane_sum_of(lanes, impl) -> tuple:
    int_from_limbs = ed25519_torch._FIELDS[impl].int_from_limbs
    coords = [c.cpu().numpy() for c in lanes.astuple()]
    total = ref.IDENTITY
    for i in range(coords[0].shape[0]):
        total = ref.pt_add(total, tuple(int_from_limbs(c[i]) % ref.P for c in coords))
    return total


@pytest.mark.parametrize("impl", ["packed", "f32"])
def test_layout_folds_match_plain_lane_for_lane(cuda, impl):
    lanes = torch.from_numpy(testkit.random_lanes(seed=18, n=301, impl=impl)).to(cuda)
    name = kernels.FOLD_KERNELS[impl]
    before = kernels.LAUNCHES[name]
    folded = kernels.rlc_fold(lanes)
    assert kernels.LAUNCHES[name] == before + 1
    plain = ed25519_torch._pt_reduce_to_lanes(ed25519_torch.lanes_to_pt(lanes.cpu(), impl), 128,
                                              impl)
    assert torch.equal(folded.cpu().to(plain.x.dtype), torch.stack(plain.astuple(), dim=1))
