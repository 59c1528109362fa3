"""The f32 layout's matrix-unit fe_mul in the port
(tendermint_tpu_torch.ops.fe25519_f32: ``inc_matrix``, ``fe_mul_mxu``,
``MXU``) and its rung of the ``auto`` ladder
(tendermint_tpu_torch.ops.ed25519_torch: ``fe_mxu_on``, ``_resolve_optin``,
``_resolve_auto_impl``, ``TM_CUDA_FE_MXU``).

The plain product is held limb for limb against the JAX package's
``_fe_mul_mxu`` and ``_fold_cols(_mul_cols(...))``, called eagerly on small
arrays at the bounds of fe_mul's contract (no compiled verify program).
The ladder and the golden gate are held with stubs, as
tests/test_optin_golden.py holds the JAX package's: a broken multiply is
refused and remembered, ``auto`` falls to packed, and f32 calls take the
FFMA kernel.  Every value is an integer: every comparison is exact."""

import functools
import types
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tendermint_tpu.ops import fe25519_f32 as jfe  # noqa: E402
from tendermint_tpu_torch import testkit  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ref  # noqa: E402
from tendermint_tpu_torch.crypto.batch import TorchBatchVerifier  # noqa: E402
from tendermint_tpu_torch.ops import ed25519_torch as dev  # noqa: E402
from tendermint_tpu_torch.ops import fe25519_f32 as tfe  # noqa: E402
from tendermint_tpu_torch.ops import kernels  # noqa: E402

CPU = torch.device("cpu")
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def clean_gate(monkeypatch):
    monkeypatch.setattr(dev, "OPTIN_STATE", {})
    for name in ("TM_CUDA_FIELD_IMPL", "TM_CUDA_BASE_MXU", "TM_CUDA_FE_MXU", "TM_CUDA_RLC"):
        monkeypatch.delenv(name, raising=False)


def test_incidence_matrix_matches_jax():
    inc = tfe.inc_matrix()
    assert inc.dtype == np.float32 and np.array_equal(inc, jfe._inc_matrix())
    assert np.array_equal(tfe.const("INC", CPU).numpy(), jfe._INC)
    assert sorted(np.unique(inc).tolist()) == [0.0, 1.0, 19.0]
    assert (np.count_nonzero(inc, axis=1) == 1).all()


def test_plain_fe_mul_mxu_matches_jax_limb_for_limb():
    """At the contract's bounds (limbs +-153 x +-102 in every sign
    pattern, 17,641 against ones) and seeded within it: the port's plain
    matrix-unit product equals the JAX ``_fe_mul_mxu`` and the JAX
    schoolbook ``_fold_cols(_mul_cols(...))``, limb for limb, and the
    port's own schoolbook ``fe_mul``."""
    a, b = testkit.fe_mul_bound_limbs(seed=3, n_random=5)
    got = tfe.fe_mul_mxu(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    jax_mxu = np.asarray(jfe._fe_mul_mxu(jnp.asarray(a), jnp.asarray(b)))
    jax_schoolbook = np.asarray(jfe._fold_cols(jfe._mul_cols(jnp.asarray(a), jnp.asarray(b))))
    assert got.dtype == np.float32 and got.shape == a.shape
    assert np.array_equal(got, jax_mxu) and np.array_equal(got, jax_schoolbook)
    assert np.array_equal(got, tfe.fe_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    for x, y, z in zip(a.astype(np.int64), b.astype(np.int64), got):
        want = tfe.int_from_limbs(x) * tfe.int_from_limbs(y) % ref.P
        assert tfe.int_from_limbs(z) % ref.P == want
    # the wrappers' CPU side is the plain version
    assert np.array_equal(tfe.fe_mul_mxu_rows(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                          got)


def test_the_mxu_field_object_multiplies_with_the_matrix_unit_product():
    """``MXU`` shares every function of the module but the multiply, and
    its point formulas give the same limbs as the FFMA ones."""
    assert tfe.MXU.fe_mul is tfe.fe_mul_mxu and tfe.MXU.fe_sq is tfe.fe_sq
    assert tfe.MXU.pt_add.keywords == {"mul": tfe.fe_mul_mxu}
    rng = np.random.default_rng(4)
    pts = [ref.scalar_mult_base(int(rng.integers(1, 1 << 40))) for _ in range(4)]
    p = tfe.Pt(*(torch.as_tensor(np.stack([tfe.limbs_from_int(q[c]) for q in pts]))
                 for c in range(4)))
    for name, args in (("pt_add", (p, p)), ("pt_dbl_n", (p, 2)), ("fe_pow_p58", (p.x,))):
        got, want = getattr(tfe.MXU, name)(*args), getattr(tfe, name)(*args)
        got = got.astuple() if hasattr(got, "astuple") else (got,)
        want = want.astuple() if hasattr(want, "astuple") else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    assert dev._core("f32", True).fe is tfe.MXU
    with pytest.raises(ValueError, match="f32 multiply"):
        dev._core("packed", True)


def test_the_knob_is_read_at_every_call(clean_gate, monkeypatch):
    """``TM_CUDA_FE_MXU``: auto (the default) is off on the CPU and on for
    cuda, as the JAX ``_use_mxu`` is off on XLA-CPU; 1 and 0 force it;
    each call reads it anew."""
    assert not dev.fe_mxu_on(CPU) and dev.fe_mxu_on(CUDA)
    for value, cpu, cuda in (("1", True, True), ("0", False, False), ("auto", False, True),
                             ("bogus", False, True)):
        monkeypatch.setenv("TM_CUDA_FE_MXU", value)
        assert (dev.fe_mxu_on(CPU), dev.fe_mxu_on(CUDA)) == (cpu, cuda), value
    assert dev.OPTIN_STATE == {}


def test_auto_stays_int64_on_the_cpu_with_no_golden_run(clean_gate):
    assert dev.default_impl(CPU) == "int64"
    assert dev._resolve_optin("f32", CPU) == (False, False)
    assert dev.OPTIN_STATE == {}


def test_every_call_resolves_fe_mxu_before_it_launches(clean_gate, monkeypatch):
    """The batch verifier, the per-row path and the RLC path (and its
    fallback) take the multiply ``TM_CUDA_FE_MXU`` names at each call,
    f32 only, once its gate passed; the RLC path asks the gate before its
    launch, as the JAX ``verify_batch_rlc`` does."""
    events = []

    def gate(flag, impl, device):
        events.append(("gate", flag, impl))
        return True

    def rows(*args, impl="int64", base_mxu=False, fe_mxu=False):
        events.append(("verify", impl, base_mxu, fe_mxu))
        return args[4]

    def rlc_rows(*args, impl="int64", fe_mxu=False):
        events.append(("rlc", impl, fe_mxu))
        return dev.verify_core_rlc(*args)  # lanes in 5 x 51-bit plain limbs

    monkeypatch.setattr(dev, "_optin_safe", gate)
    monkeypatch.setattr(dev, "verify_rows", rows)
    monkeypatch.setattr(dev, "verify_rows_rlc", rlc_rows)
    monkeypatch.setattr(dev, "finalize_rlc", lambda lanes, c_row, impl: False)  # fallback
    pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
    bv = TorchBatchVerifier(device="cpu")  # built before the knobs are set
    for impl, fe_mxu, rlc, want in (("f32", "1", "0", ("verify", "f32", False, True)),
                                    ("f32", "0", "0", ("verify", "f32", False, False)),
                                    ("packed", "1", "0", ("verify", "packed", False, False)),
                                    ("f32", "auto", "0", ("verify", "f32", False, False)),
                                    ("f32", "1", "1", ("verify", "f32", False, True))):
        monkeypatch.setenv("TM_CUDA_FIELD_IMPL", impl)
        monkeypatch.setenv("TM_CUDA_FE_MXU", fe_mxu)
        monkeypatch.setenv("TM_CUDA_RLC", rlc)
        events.clear()
        bv.add(pub, msg, sig)
        assert bv.verify() == (True, [True])
        assert events[-1] == want, (impl, fe_mxu, rlc)
        gated = impl == "f32" and fe_mxu == "1"
        assert (("gate", "fe_mxu", "f32") in events) == gated
        if rlc == "1":
            assert events == [("gate", "fe_mxu", "f32"), ("rlc", "f32", True), want]


def _broken_mxu():
    """``fe25519_f32.MXU`` whose multiply returns zeros: the right shape and
    dtype, the wrong value (as the JAX package's own gate test breaks
    ``_fe_mul_mxu``)."""
    def broken(a, b):
        return torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=tfe.DTYPE)

    fields = dict(vars(tfe.MXU))
    fields.update(fe_mul=broken,
                  **{name: functools.partial(getattr(tfe, name), mul=broken)
                     for name in ("fe_pow_p58", "pt_add", "pt_dbl", "pt_dbl_n")})
    return types.SimpleNamespace(**fields)


@pytest.fixture
def broken_mxu(monkeypatch):
    monkeypatch.setattr(tfe, "MXU", _broken_mxu())
    dev._core.cache_clear()
    yield
    dev._core.cache_clear()


def test_a_wrong_multiply_is_refused_and_f32_takes_the_ffma_path(clean_gate, broken_mxu,
                                                                  monkeypatch):
    """``TM_CUDA_FE_MXU=1`` with a multiply that computes garbage: its
    golden batch fails on this device, the gate warns and remembers the
    refusal under ("fe_mxu", "f32", device type), and the f32 call
    verifies with the FFMA multiply, rightly."""
    monkeypatch.setenv("TM_CUDA_FE_MXU", "1")
    keys = testkit.validator_keys(seed=23, n=4)
    msgs = [b"fe_mxu %d" % i for i in range(4)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[1] = sigs[1][:-1] + bytes([sigs[1][-1] ^ 1])
    pubs = [k.pub_key().bytes_() for k in keys]
    with pytest.warns(UserWarning, match="WRONG verdicts"):
        got = dev.verify_batch(pubs, msgs, sigs, impl="f32", device="cpu")
    assert got.tolist() == [True, False, True, True]
    assert dev.OPTIN_STATE == {("fe_mxu", "f32", "cpu"): False}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # memoised: no second golden run
        assert dev._resolve_optin("f32", CPU) == (False, False)


def test_a_refused_multiply_sends_auto_to_packed_then_int64(clean_gate, monkeypatch):
    """On the card, with the golden runs stubbed: the tensor-core multiply
    computes wrong verdicts, so ``auto`` falls to packed (whose gate
    passes) and f32 calls take ``ed25519_verify_f32``; with the packed
    kernel refused as well, ``auto`` takes int64."""
    rows, want = dev._golden_batch()
    wrong = [not v for v in want]

    def golden(*args, impl, base_mxu, fe_mxu):
        bad = fe_mxu or impl in refused
        return torch.tensor(wrong if bad else want)

    refused = set()
    monkeypatch.setattr(kernels, "library", lambda: None)
    monkeypatch.setattr(dev, "rows_to_device", lambda rows, device: rows)
    monkeypatch.setattr(dev, "verify_rows", golden)
    with pytest.warns(UserWarning, match="WRONG verdicts"):
        assert dev._resolve_auto_impl(CUDA) == "packed"
    assert dev.OPTIN_STATE == {("fe_mxu", "f32", "cuda"): False, ("impl", "packed", "cuda"): True}
    base_mxu, fe_mxu = dev._resolve_optin("f32", CUDA)
    assert kernels.VERIFY_KERNELS[("f32", base_mxu, fe_mxu)] == "ed25519_verify_f32"
    monkeypatch.setattr(dev, "OPTIN_STATE", {})
    refused.add("packed")
    with pytest.warns(UserWarning, match="WRONG verdicts"):
        assert dev._resolve_auto_impl(CUDA) == "int64"
    assert dev.OPTIN_STATE == {("fe_mxu", "f32", "cuda"): False,
                               ("impl", "packed", "cuda"): False}


def test_the_comb_is_gated_with_the_multiply_it_will_run_with(clean_gate, monkeypatch):
    """f32 with both opt-ins runs ``ed25519_verify_f32_mma_comb``, so that
    kernel's golden run ("base_mxu+fe_mxu") is the comb's gate; with the
    multiply refused the comb is gated on the FFMA kernel."""
    asked = []

    def gate(flag, impl, device):
        asked.append(flag)
        return flag != "fe_mxu" or passes

    monkeypatch.setattr(dev, "_optin_safe", gate)
    monkeypatch.setenv("TM_CUDA_BASE_MXU", "1")
    passes = True
    assert dev._resolve_optin("f32", CUDA) == (True, True)
    assert asked == ["fe_mxu", "base_mxu+fe_mxu"]
    assert kernels.VERIFY_KERNELS[("f32", True, True)] == "ed25519_verify_f32_mma_comb"
    asked.clear()
    passes = False
    assert dev._resolve_optin("f32", CUDA) == (True, False)
    assert asked == ["fe_mxu", "base_mxu"]
    asked.clear()
    assert dev._resolve_optin("int64", CUDA) == (True, False)
    assert asked == ["base_mxu"]


def test_the_combined_gate_runs_its_kernel_on_the_cpu(clean_gate):
    """The golden batch through the plain f32 verify with the comb and
    the matrix-unit multiply: it passes, and is remembered."""
    assert dev._optin_safe("base_mxu+fe_mxu", "f32", CPU)
    assert dev.OPTIN_STATE == {("base_mxu+fe_mxu", "f32", "cpu"): True}
