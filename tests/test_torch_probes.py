"""The port's device probes (``tendermint_tpu_torch/benchmarks``) on the CPU:
the plain versions of the probe kernels against the JAX package's own
``benchmarks/roofline_probe.py`` (its Pallas kernels in interpret mode and
its chain programs, on XLA-CPU, in a subprocess), the host build of
``csrc/probes.cu`` against the plain versions, and the three entry points
(raise without a card unless asked for the CPU; the originals' keys).
Integer chains are compared exactly; f32mul's sum to rtol 1e-6, since
only the order of the reduction differs (the chain itself is one IEEE
multiply per step)."""

import ast
import contextlib
import ctypes
import fcntl
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.benchmarks import kernel_bench, rlc_bench, roofline_probe
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parent.parent

# the keys of the originals' lines (benchmarks/kernel_bench.py and
# benchmarks/rlc_bench.py docstrings; benchmarks/roofline_probe.py run_chain
# and run_pallas)
KERNEL_BENCH_KEYS = {"impl", "batch", "platform", "device_ms", "device_ms_min", "us_per_sig",
                     "host_prep_ms", "compile_s", "verify_ok"}
RLC_BENCH_KEYS = {"impl", "batch", "platform", "rlc_device_ms", "row_device_ms", "speedup",
                  "us_per_sig_rlc", "host_scalars_ms", "rlc_ok", "mixed_verdicts_exact"}
CHAIN_KEYS = {"probe", "kind", "platform", "rows", "lanes", "chain", "ms", "ms_min", "compile_s"}
PALLAS_KEYS = {"probe", "kind", "platform", "rows", "chain", "ms", "ms_min", "compile_s"}
CENSUS_KEYS = {"probe", "impl", "lane_ops_per_sig", "lane_mul_per_sig",
               "lane_ops_total_per_sig", "calls", "note"}

# (kind, rows, lanes) of each JAX chain probe the oracle records, at chain 4
ORACLE_CHAINS = [("floor", 8, 128), ("i64mul", 64, 128), ("i64add", 64, 128),
                 ("i32mul", 64, 128), ("f32mul", 64, 128), ("femul17", 16, 15),
                 ("femul8", 16, 32)]
ORACLE_CHAIN_LEN = 4

_ORACLE = r"""
import functools, json, os, sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
from jax.experimental import pallas

pallas.pallas_call = functools.partial(pallas.pallas_call, interpret=True)
records = []
real_jit = jax.jit


def recording_jit(fun, *args, **kwargs):
    jitted = real_jit(fun, *args, **kwargs)
    if getattr(fun, "__module__", None) != "roofline_probe":
        return jitted

    def call(*inputs):
        out = jitted(*inputs)
        records.append(([np.asarray(x) for x in inputs],
                        [np.asarray(o) for o in jax.tree_util.tree_leaves(out)]))
        return out

    return call


jax.jit = recording_jit
root, out_path = sys.argv[1], sys.argv[2]
chains, chain_len = json.loads(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, os.path.join(root, "benchmarks"))
import roofline_probe as rp

saved, results = {}, {}


def keep(name, res):
    inputs, outs = records[0]
    records.clear()
    saved[name + "_x"], saved[name + "_y"] = inputs
    for i, o in enumerate(outs):
        saved[f"{name}_out{i}"] = o
    results[name] = res


keep("pl_i32mul", rp.run_pallas("pl_i32mul", 2048, 3, 1, "cpu"))
keep("pl_femul8", rp.run_pallas("pl_femul8", 2048, 1, 1, "cpu"))
for kind, rows, lanes in chains:
    keep(kind, rp.run_chain(kind, rows, lanes, chain_len, 1, "cpu"))
saved["results"] = np.array(json.dumps(results))
np.savez(out_path, **saved)
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX package's own probes on XLA-CPU, their inputs and outputs
    recorded: one subprocess (run_pallas turns x64 off for the whole
    process, which must not reach this worker's other tests), run once per
    test session and shared by its xdist workers under a file lock."""
    shared = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        shared = shared.parent  # the session's directory, above each worker's
    out = shared / "torch_probes_oracle.npz"
    with open(shared / "torch_probes_oracle.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            part = shared / f"torch_probes_oracle.{os.getpid()}.npz"
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            proc = subprocess.run([sys.executable, "-c", _ORACLE, str(ROOT), str(part),
                                   json.dumps(ORACLE_CHAINS), str(ORACLE_CHAIN_LEN)],
                                  capture_output=True, text=True, timeout=600, env=env,
                                  cwd=ROOT)
            assert proc.returncode == 0, proc.stderr[-4000:]
            part.replace(out)
    with np.load(out) as data:
        rec = {k: data[k] for k in data.files}
    rec["results"] = json.loads(str(rec["results"]))
    return rec


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_jax_probes_agree_with_big_int(oracle):
    for name in ("pl_femul8", "femul17", "femul8"):
        assert oracle["results"][name]["agree"] is True


def test_pl_i32mul_plain_matches_the_pallas_kernel(oracle):
    x, y = oracle["pl_i32mul_x"], oracle["pl_i32mul_y"]
    got = roofline_probe.op_chain_plain("i32mul", _t(x), _t(y), 3)
    assert got.dtype == torch.int32
    assert int(got.sum()) == int(oracle["pl_i32mul_out0"])
    want = x.copy()
    for _ in range(3):
        want = (want * y) & np.int32(255)
    assert np.array_equal(got.numpy(), want)


def test_pl_femul8_plain_matches_the_pallas_kernel(oracle):
    x, y = oracle["pl_femul8_x"], oracle["pl_femul8_y"]
    assert x.shape == (32, 2048)
    got = roofline_probe.femul8_chain_plain(_t(x), _t(y), 1, limb_major=True)
    assert np.array_equal(got[:, 0].numpy(), oracle["pl_femul8_out0"])
    assert int(got.to(torch.int64).sum()) == int(oracle["pl_femul8_out1"])


@pytest.mark.parametrize("kind", ["floor", "i64mul", "i64add", "i32mul", "f32mul"])
def test_op_chain_plain_matches_the_jax_chain(oracle, kind):
    x, y = oracle[f"{kind}_x"], oracle[f"{kind}_y"]
    got = roofline_probe.op_chain_plain(kind, _t(x), _t(y), ORACLE_CHAIN_LEN)
    assert got.dtype == kernels.OP_CHAIN_KINDS[kind][0]
    want = oracle[f"{kind}_out0"]
    if kind == "f32mul":
        assert float(got.sum()) == pytest.approx(float(want), rel=1e-6)
    else:
        assert int(got.to(torch.int64).sum()) == int(want)


def test_femul8_row_major_plain_matches_the_jax_chain(oracle):
    x, y = oracle["femul8_x"], oracle["femul8_y"]
    got = roofline_probe.femul8_chain_plain(_t(x), _t(y), ORACLE_CHAIN_LEN, limb_major=False)
    assert np.array_equal(got[0].numpy(), oracle["femul8_out0"])
    assert int(got.to(torch.int64).sum()) == int(oracle["femul8_out1"])


def test_fe_mul_chain_plain_matches_the_jax_femul17_mod_p(oracle):
    """The layouts differ (15 x 17 bits there, 5 x 51 here): the recorded
    inputs go through big-int into 51-bit limbs, and only canonical values
    are compared."""
    def to51(rows17):
        vals = [roofline_probe.int_from_limbs(row, 17) for row in rows17]
        return np.array([[(v >> (51 * i)) & roofline_probe.MASK51 for i in range(5)]
                         for v in vals], dtype=np.int64)

    x, y = to51(oracle["femul17_x"]), to51(oracle["femul17_y"])
    got = roofline_probe.fe_mul51_chain_plain(_t(x), _t(y), ORACLE_CHAIN_LEN).numpy()
    want = roofline_probe.int_from_limbs(oracle["femul17_out0"], 17) % ref.P
    assert roofline_probe.int_from_limbs(got[0], 51) % ref.P == want
    for i in range(len(x)):  # every row against big-int
        xi, yi = (roofline_probe.int_from_limbs(a[i], 51) for a in (x, y))
        assert (roofline_probe.int_from_limbs(got[i], 51) % ref.P
                == xi * pow(yi, ORACLE_CHAIN_LEN, ref.P) % ref.P)


# ---------------------------------------------------------------------------
# The host build of csrc/probes.cu against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probes_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("host") / "libprobes.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(out),
                    str(kernels.CSRC / "probes.cu")], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.tm_host_op_chain.restype = ctypes.c_int
    lib.tm_host_op_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong]
    return lib


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


CHAIN = 37  # two unrolled loops of 16 and a remainder of 5


@pytest.mark.parametrize("kind", sorted(kernels.OP_CHAIN_KINDS))
def test_op_chain_host_build_matches_plain(probes_lib, kind):
    x, y = roofline_probe.chain_inputs(kind, 5, 33)
    out = np.zeros_like(x)
    _, mask, code = kernels.OP_CHAIN_KINDS[kind]
    assert probes_lib.tm_host_op_chain(_p(x), _p(y), _p(out), x.size, CHAIN, code, mask) == 0
    assert np.array_equal(out, roofline_probe.op_chain_plain(kind, _t(x), _t(y), CHAIN).numpy())


def test_pl_i32mul_host_build_matches_plain(probes_lib):
    """pl_i32mul's rows of 128 through op_chain's entry, with the kind
    code and mask its wrapper passes."""
    x, y = roofline_probe.pallas_inputs("pl_i32mul", 6)
    out = np.zeros_like(x)
    _, mask, code = kernels.OP_CHAIN_KINDS["i32mul"]
    assert (mask, code) == (255, 0)
    assert probes_lib.tm_host_op_chain(_p(x), _p(y), _p(out), x.size, CHAIN, code, mask) == 0
    assert np.array_equal(out, roofline_probe.op_chain_plain("i32mul", _t(x), _t(y),
                                                             CHAIN).numpy())


@pytest.mark.parametrize("limb_major", [True, False])
def test_pl_femul8_host_build_matches_plain(probes_lib, limb_major):
    if limb_major:
        x, y = roofline_probe.pallas_inputs("pl_femul8", 24)
    else:
        x, y = roofline_probe.chain_inputs("femul8", 24, 32)
    out = np.zeros_like(x)
    probes_lib.tm_host_pl_femul8(_p(x), _p(y), _p(out), 24, 3, int(limb_major))
    want = roofline_probe.femul8_chain_plain(_t(x), _t(y), 3, limb_major)
    assert np.array_equal(out, want.numpy())


def test_fe_mul_chain_host_build_matches_plain(probes_lib):
    x, y = roofline_probe.chain_inputs("femul51", 40, 5)
    x[0] = roofline_probe.MASK51  # every limb at its top
    y[1] = roofline_probe.MASK51
    out = np.zeros_like(x)
    probes_lib.tm_host_fe_mul_chain(_p(x), _p(y), _p(out), 40, 6)
    assert np.array_equal(out, roofline_probe.fe_mul51_chain_plain(_t(x), _t(y), 6).numpy())


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def _lines(main, argv) -> list[dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("main,argv", [
    (roofline_probe.main, ["--pallas-kind", "pl_i32mul", "--rows", "8"]),
    (roofline_probe.main, ["--census"]),
    (kernel_bench.main, ["--batch", "8"]),
    (rlc_bench.main, ["--batch", "8"]),
])
def test_entry_points_raise_without_cuda(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def test_probe_wrappers_refuse_cpu_tensors():
    """The plain versions run only where the caller picked the CPU:
    the wrappers take CUDA tensors or raise, and count nothing."""
    before = dict(kernels.LAUNCHES)
    i32 = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.pl_i32mul(i32, i32, 2)
    for kind, (dtype, _, _) in kernels.OP_CHAIN_KINDS.items():
        x = torch.zeros((4, 8), dtype=dtype)
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.op_chain(kind, x, x, 2)
    with pytest.raises(ValueError, match="no op_chain kind"):
        kernels.op_chain("femul17", i32, i32, 2)
    limbs = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.pl_femul8(limbs, limbs, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.pl_femul8(limbs.T.contiguous(), limbs.T.contiguous(), 2, limb_major=False)
    rows = torch.zeros((4, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.fe_mul_chain(rows, rows, 2)
    assert kernels.LAUNCHES == before


def test_kernel_bench_on_the_cpu():
    (line,) = _lines(kernel_bench.main, ["--device", "cpu", "--batch", "8", "--reps", "1"])
    assert KERNEL_BENCH_KEYS <= line.keys()
    assert line["verify_ok"] is True and line["platform"] == "cpu"
    assert line["device_ms"] is None and line["plain_ms"] > 0


def test_rlc_bench_on_the_cpu():
    (line,) = _lines(rlc_bench.main, ["--device", "cpu", "--batch", "8", "--reps", "1"])
    assert RLC_BENCH_KEYS <= line.keys()
    assert line["rlc_ok"] is True and line["mixed_verdicts_exact"] is True
    assert line["rlc_device_ms"] is None and line["platform"] == "cpu"


def test_roofline_probe_on_the_cpu():
    base = ["--device", "cpu", "--reps", "1"]
    (chain,) = _lines(roofline_probe.main, base + ["--chain", "femul8", "--rows", "8",
                                                   "--lanes", "32", "--chain-len", "2"])
    assert CHAIN_KEYS | {"agree", "ns_per_femul_elem"} <= chain.keys()
    assert chain["agree"] is True and chain["bound_ms"] is None
    (pallas,) = _lines(roofline_probe.main, base + ["--pallas-kind", "pl_i32mul", "--rows",
                                                    "8", "--chain-len", "3"])
    assert PALLAS_KEYS | {"g_ops_per_s"} <= pallas.keys()
    census = _lines(roofline_probe.main, base + ["--census"])
    assert {line["kernel"] for line in census} == set(kernels.VERIFY_KERNELS.values())
    assert all(CENSUS_KEYS <= line.keys() for line in census)
    int64 = next(line for line in census if line["kernel"] == "ed25519_verify")
    assert int64["lane_ops_per_sig"] == kernels.operations("ed25519_verify", 1)


def test_sass_loop_reads_the_largest_loop_and_prices_its_pipes():
    sass = """
        Function : op_chain_i32mul
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;  /* 0x000 */
                                                                            /* 0x000 */
        /*0010*/                   IMAD R5, R2, R3, RZ ;
        /*0020*/                   LOP3.LUT R5, R5, R4, RZ, 0xc0, !PT ;
        /*0030*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0040*/                   ISETP.GE.AND P0, PT, R6, R7, PT ;
        /*0050*/              @!P0 BRA 0x10 ;
        /*0060*/                   IMAD R5, R2, R3, RZ ;
        /*0070*/              @!P1 BRA 0x60 ;
        /*0080*/                   STG.E [R8.64], R5 ;
        /*0090*/                   EXIT ;
        Function : other
        /*0000*/                   BRA 0x0 ;
    """
    loop = roofline_probe.sass_loop(sass, "op_chain_i32mul")
    assert loop == {"IMAD": 1, "LOP3.LUT": 1, "IADD3": 1, "ISETP.GE.AND": 1, "BRA": 1}
    assert roofline_probe.step_instructions(loop, 1) == {"alu": 3, "imad": 1}


def test_femul51_bound_is_priced_as_the_verify_kernels_multiply():
    """One function, one bound: femul51's step is priced at the verify
    bounds' 100 IMAD a multiply, not its SASS; bytes at 3.35 TB/s."""
    rates = kernels.pipe_rates(132, 1980.0)
    assert rates["imad"] == 132 * 64 * 1980e6 and rates["alu"] == rates["imad"]
    priced = roofline_probe.PRICED_STEPS["femul51"]
    assert priced == {"imad": kernels.LAYOUT_PRODUCTS["51"][0]} == {"imad": 100}
    steps = 65536 * 256
    got = roofline_probe.bounds_ms(priced, steps, 3 * 65536 * 5 * 8, rates)
    assert got["imad"] == pytest.approx(100 * steps / rates["imad"] * 1e3)
    assert got["imad"] == pytest.approx(0.10030, rel=1e-4)
    assert got["bytes"] == pytest.approx(3 * 65536 * 40 / 3.35e12 * 1e3)
    sass = roofline_probe.bounds_ms({"imad": 134, "alu": 149}, steps, 0, rates)
    assert max(sass, key=sass.get) == "alu"
    assert roofline_probe.PRICED_STEPS.keys() == {"femul51"}


def test_the_port_probes_import_nothing_of_the_jax_package():
    """Nor the JAX package's benchmarks/ modules (kernel_bench,
    roofline_probe, rlc_bench are top-level names there)."""
    forbidden = {"jax", "jaxlib", "tendermint_tpu", "benchmarks", "kernel_bench",
                 "roofline_probe", "rlc_bench"}
    files = sorted((ROOT / "tendermint_tpu_torch" / "benchmarks").glob("*.py"))
    assert {f.name for f in files} >= {"roofline_probe.py", "kernel_bench.py", "rlc_bench.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & forbidden, (path.name, names)


def test_chip_smoke_alone_says_what_it_needs(tmp_path):
    """A copy of the script without the package beside it exits non-zero
    with one line that says so, and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert proc.stderr.count("\n") == 1 and "tendermint_tpu_torch" in proc.stderr
