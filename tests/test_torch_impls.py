"""The port's field layouts and the comb on the CPU
(tendermint_tpu_torch.ops.ed25519_torch): the plain verify in every
layout and with the comb against the pure ZIP-215 reference, the packed
verdicts against the JAX package's ``_compiled(8, "packed")`` (a program
its own tests compile), the comb table and the golden batch against the
JAX package's, and the ``TM_CUDA_FIELD_IMPL`` / ``TM_CUDA_BASE_MXU`` /
``TM_CUDA_FE_MXU`` ladder and golden-batch gate.  No f32 or comb program
of the JAX package is compiled here.  Verdicts, tables and rows are
compared exactly."""

import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tendermint_tpu.ops import ed25519_jax as jdev  # noqa: E402
from tendermint_tpu_torch import convert, testkit  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ref  # noqa: E402
from tendermint_tpu_torch.crypto.batch import TorchBatchVerifier  # noqa: E402
from tendermint_tpu_torch.ops import ed25519_torch as dev  # noqa: E402
from tendermint_tpu_torch.ops import kernels  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gauntlet():
    cases = testkit.adversarial_cases(seed=0)
    triples = tuple([c[i] for c in cases] for i in range(3))
    want = [ref.verify(*c) for c in cases]
    return triples, want


@pytest.fixture
def clean_gate(monkeypatch):
    monkeypatch.setattr(dev, "OPTIN_STATE", {})
    monkeypatch.delenv("TM_CUDA_FIELD_IMPL", raising=False)
    monkeypatch.delenv("TM_CUDA_BASE_MXU", raising=False)
    monkeypatch.delenv("TM_CUDA_FE_MXU", raising=False)


@pytest.mark.parametrize("impl,base_mxu,fe_mxu", sorted(kernels.VERIFY_KERNELS))
def test_plain_verify_matches_the_reference_in_every_layout(gauntlet, impl, base_mxu, fe_mxu):
    (pubs, msgs, sigs), want = gauntlet
    rows = dev.rows_to_device(dev.prepare_batch(pubs, msgs, sigs), CPU)
    got = dev.verify_rows(*rows, impl=impl, base_mxu=base_mxu, fe_mxu=fe_mxu)
    assert got.tolist() == want
    assert any(want) and not all(want)


def test_packed_verdicts_match_the_jax_packed_program(gauntlet):
    """The gauntlet in blocks of 8 rows through the JAX package's packed
    program of bucket 8 and the port's plain packed verify."""
    (pubs, msgs, sigs), want = gauntlet
    program = jdev._compiled(8, "packed")
    for start in range(0, len(pubs), 8):
        cut = slice(start, start + 8)
        rows = dev.prepare_batch(pubs[cut], msgs[cut], sigs[cut])
        n = len(rows[4])
        jax_got = np.asarray(program(*jdev._pad_rows(n, 8, *rows)))[:n]
        port = dev.verify_rows(*dev.rows_to_device(rows, CPU), impl="packed")
        assert port.tolist() == jax_got.tolist() == want[cut]


@pytest.mark.parametrize("impl", ["int64", "f32"])
def test_comb_table_matches_jax(impl):
    """The kernels' byte table, which the plain comb reads too, is the JAX
    package's ``_fixed_base_tables256`` (float32 there, exact for these
    limbs): unpacked to `impl`'s limbs it equals that table limb for
    limb, and ``convert`` makes it from that table."""
    jax_table = jdev._core(impl)._fixed_base_tables256
    byte_table = kernels.comb_table(CPU)  # [32, 256, 128]: window, digit, byte
    limbs = dev._FIELDS[impl].fe_from_bytes(byte_table.reshape(32, 256, 4, 32)).reshape(
        32, 256, -1)
    assert limbs.shape == jax_table.shape
    assert np.array_equal(limbs.numpy().astype(np.float64), jax_table.astype(np.float64))
    assert np.array_equal(convert.comb_table_from_jax(jax_table, impl).numpy(),
                          byte_table.numpy())


def test_golden_batch_rows_match_jax():
    rows, want = dev._golden_batch()
    jax_rows, jax_want = jdev._golden_batch()
    assert want == jax_want == [True, True, True, False, True, True, False, True]
    for name, p, j in zip(("pub", "r", "s", "k", "valid"), rows, jax_rows):
        assert p.dtype == j.dtype and np.array_equal(p, j), name


def test_auto_is_int64_on_the_cpu_without_a_golden_run(clean_gate):
    assert dev.default_impl(CPU) == "int64"
    assert dev.OPTIN_STATE == {}
    # unknown values take the auto path, named ones bypass it
    for value, want in (("bogus", "int64"), ("packed", "packed"), ("f32", "f32"),
                        ("int64", "int64")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TM_CUDA_FIELD_IMPL", value)
            assert dev.default_impl(CPU) == want
    assert dev.OPTIN_STATE == {}


def test_auto_ladder_order_on_the_card_with_the_gate_stubbed(clean_gate, monkeypatch):
    """The JAX ladder: f32 with its matrix-unit fe_mul where that gate
    passes, else packed where its gate passes, else int64; with
    ``TM_CUDA_FE_MXU=0`` the f32 rung is never asked, even when every
    gate would pass."""
    cuda = torch.device("cuda")
    asked = []

    def gate(answer):
        def stub(flag, impl, device):
            asked.append((flag, impl, device.type))
            return answer(flag, impl)
        return stub

    monkeypatch.setattr(dev, "_optin_safe", gate(lambda flag, impl: True))
    assert dev._resolve_auto_impl(cuda) == "f32"
    monkeypatch.setattr(dev, "_optin_safe", gate(lambda flag, impl: impl == "packed"))
    assert dev._resolve_auto_impl(cuda) == "packed"
    monkeypatch.setattr(dev, "_optin_safe", gate(lambda flag, impl: False))
    assert dev._resolve_auto_impl(cuda) == "int64"
    assert set(asked) == {("fe_mxu", "f32", "cuda"), ("impl", "packed", "cuda")}
    asked.clear()
    monkeypatch.setenv("TM_CUDA_FE_MXU", "0")
    monkeypatch.setattr(dev, "_optin_safe", gate(lambda flag, impl: True))
    assert dev._resolve_auto_impl(cuda) == "packed"
    assert asked == [("impl", "packed", "cuda")]


def test_a_refused_gate_warns_and_routes_to_int64(clean_gate, monkeypatch):
    """The packed kernel's launch fails (the wrappers' RuntimeError): the
    gate warns, refuses, remembers, and auto takes int64 on the card."""
    def launch_fails(*rows, impl, base_mxu, fe_mxu):
        kernels._raise_on(700, kernels.VERIFY_KERNELS[(impl, base_mxu, fe_mxu)])

    monkeypatch.setattr(kernels, "library", lambda: None)
    monkeypatch.setattr(dev, "rows_to_device", lambda rows, device: rows)
    monkeypatch.setattr(dev, "verify_rows", launch_fails)
    with pytest.warns(UserWarning) as record:
        assert dev._resolve_auto_impl(torch.device("cuda")) == "int64"
    messages = [str(w.message) for w in record]
    assert any("with an error" in m and "launch failed" in m for m in messages)
    assert any("WRONG verdicts" in m for m in messages)
    assert dev.OPTIN_STATE == {("fe_mxu", "f32", "cuda"): False,
                               ("impl", "packed", "cuda"): False}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dev._resolve_auto_impl(torch.device("cuda")) == "int64"  # memoised


def test_a_code_defect_raises_through_the_gate(clean_gate, monkeypatch):
    """A wrapper that refuses its input (a ValueError, as ``kernels._check``
    raises) is a defect of the code, not of the device: the gate lets it
    through and remembers nothing."""
    def refuses(*rows, impl, base_mxu, fe_mxu):
        raise ValueError("pub: expected torch.uint8, got torch.int64")

    monkeypatch.setattr(kernels, "library", lambda: None)
    monkeypatch.setattr(dev, "rows_to_device", lambda rows, device: rows)
    monkeypatch.setattr(dev, "verify_rows", refuses)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="expected torch.uint8"):
            dev._optin_safe("impl", "packed", torch.device("cuda"))
    assert dev.OPTIN_STATE == {}


def test_a_kernel_that_fails_to_build_raises_through_the_gate(clean_gate, monkeypatch):
    def no_build():
        raise RuntimeError("nvcc failed on ed25519_verify_packed.cu (1)")

    monkeypatch.setattr(kernels, "library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dev._optin_safe("impl", "packed", torch.device("cuda"))
    assert dev.OPTIN_STATE == {}


def test_a_wrong_comb_is_refused_and_verdicts_stay_right(clean_gate, monkeypatch):
    """TM_CUDA_BASE_MXU=1 with a comb that computes garbage (the
    identity): its golden batch fails on this device, the flag is refused
    with a warning, and the standard path gives the right verdicts."""
    monkeypatch.setenv("TM_CUDA_BASE_MXU", "1")
    monkeypatch.setattr(dev._Core, "scalarmul_base_mxu",
                        lambda self, s: self.fe.pt_identity(s.shape[:-1], s.device))
    keys = testkit.validator_keys(seed=21, n=4)
    msgs = [b"comb %d" % i for i in range(4)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[2] = sigs[2][:-1] + bytes([sigs[2][-1] ^ 1])
    with pytest.warns(UserWarning, match="WRONG verdicts"):
        got = dev.verify_batch([k.pub_key().bytes_() for k in keys], msgs, sigs, device="cpu")
    assert got.tolist() == [True, True, False, True]
    assert dev.OPTIN_STATE == {("base_mxu", "int64", "cpu"): False}


def test_the_comb_gate_passes_on_the_cpu_and_packed_never_asks_it(clean_gate, monkeypatch):
    monkeypatch.setenv("TM_CUDA_BASE_MXU", "1")
    assert dev._resolve_optin("int64", CPU) == (True, False)
    assert dev._resolve_optin("packed", CPU) == (False, False)
    assert dev.OPTIN_STATE == {("base_mxu", "int64", "cpu"): True}
    monkeypatch.setenv("TM_CUDA_BASE_MXU", "0")
    assert dev._resolve_optin("int64", CPU) == (False, False)
    with pytest.raises(ValueError, match="not offered for packed"):
        dev.verify_rows(*(torch.zeros((1, 32), dtype=torch.uint8),) * 4,
                        torch.ones(1, dtype=torch.bool), impl="packed", base_mxu=True)


def test_both_knobs_are_read_at_every_call(clean_gate, monkeypatch):
    """TorchBatchVerifier, verify_batch and the RLC fallback take the layout
    and the comb the knobs name at the moment of each call."""
    calls = []

    def record(self, pub, r, s, k, valid, base_mxu=False):
        calls.append((self.impl, base_mxu))
        return valid

    monkeypatch.setattr(dev._Core, "verify_core", record)
    monkeypatch.setattr(dev, "_optin_safe", lambda flag, impl, device: True)
    pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
    bv = TorchBatchVerifier(device="cpu")  # built before the knobs are set
    for impl, mxu, want in (("packed", "1", ("packed", False)), ("f32", "0", ("f32", False)),
                            ("f32", "1", ("f32", True)), ("int64", "1", ("int64", True)),
                            ("auto", "0", ("int64", False))):
        monkeypatch.setenv("TM_CUDA_FIELD_IMPL", impl)
        monkeypatch.setenv("TM_CUDA_BASE_MXU", mxu)
        bv.add(pub, msg, sig)
        assert bv.verify() == (True, [True])
        assert calls[-1] == want, (impl, mxu)
    # the RLC path's per-row fallback: a bad row fails the equation
    monkeypatch.setenv("TM_CUDA_FIELD_IMPL", "packed")
    bad = sig[:-1] + bytes([sig[-1] ^ 1])
    before = dict(dev.RLC_STATS)
    dev.verify_batch_rlc([pub, pub], [msg, msg], [sig, bad], device="cpu")
    assert dev.RLC_STATS["fallback"] == before["fallback"] + 1
    assert calls[-1] == ("packed", False)
