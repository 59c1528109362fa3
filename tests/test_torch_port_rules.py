"""Rules the port keeps: it imports neither jax nor the JAX package, its
entry points never fall back to the CPU, and its kernel wrappers take
CUDA tensors only."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import testkit
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.crypto.batch import TorchBatchVerifier, new_batch_verifier
from tendermint_tpu_torch.ops import ed25519_torch, kernels

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "tendermint_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "tendermint_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((path.relative_to(ROOT).as_posix(), mod))
    assert not bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("impl", [None, "auto", "int64", "packed", "f32"])
def test_entry_points_raise_without_cuda(no_cuda, monkeypatch, impl):
    """Whatever TM_CUDA_FIELD_IMPL (and TM_CUDA_BASE_MXU) say."""
    if impl is None:
        monkeypatch.delenv("TM_CUDA_FIELD_IMPL", raising=False)
    else:
        monkeypatch.setenv("TM_CUDA_FIELD_IMPL", impl)
        monkeypatch.setenv("TM_CUDA_BASE_MXU", "1")
    pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        ed25519_torch.verify_batch([pub], [msg], [sig])
    bv = TorchBatchVerifier()
    bv.add(pub, msg, sig)
    with pytest.raises(RuntimeError, match="CUDA"):
        bv.verify()
    keys = testkit.validator_keys(seed=1, n=4)
    vals = testkit.validator_set(keys)
    commit = testkit.signed_commit(keys, vals, height=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        vals.verify_commit(testkit.CHAIN_ID, testkit.block_id_for(3), 3, commit)
    # the plain version runs only when asked for
    vals.verify_commit(testkit.CHAIN_ID, testkit.block_id_for(3), 3, commit, device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    rows = torch.zeros((4, 32), dtype=torch.uint8)
    valid = torch.ones(4, dtype=torch.bool)
    table = torch.zeros((64, 16, 4, 5), dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.ed25519_verify(rows, rows, rows, rows, valid, table)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.fe_ops(rows, rows)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.decompress(rows)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.ed25519_rlc(rows, rows, rows, rows[:, :16].contiguous(), valid)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.rlc_fold(torch.zeros((130, 4, 5), dtype=torch.int64))
    for impl, base_mxu, fe_mxu in kernels.VERIFY_KERNELS:
        cpu_table = ed25519_torch.kernel_table(impl, base_mxu, torch.device("cpu"))
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.verify(impl, base_mxu, fe_mxu)(rows, rows, rows, rows, valid, cpu_table)
    for impl, fe_mxu in kernels.RLC_KERNELS:
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.rlc(impl, fe_mxu)(rows, rows, rows, rows[:, :16].contiguous(), valid)
    for dtype, limbs in kernels.LANE_LIMBS.values():
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.rlc_fold(torch.zeros((130, 4, limbs), dtype=dtype))
    limbs = torch.zeros((4, 51), dtype=torch.float32)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.fe_mul_mma(limbs, limbs)
    for wrapper in (kernels.fe_ops_packed, kernels.fe_ops_f32):
        with pytest.raises(ValueError, match="expected a tensor on"):
            wrapper(rows, rows)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.comb_select(rows, torch.zeros(kernels.COMB_SHAPE, dtype=torch.uint8))
    with pytest.raises(ValueError, match="no verify kernel"):
        kernels.verify("packed", True)
    with pytest.raises(ValueError, match="no verify kernel"):
        kernels.verify("int64", False, True)
    with pytest.raises(ValueError, match="no RLC kernel"):
        kernels.rlc("packed", True)
    assert kernels.LAUNCHES == before


def test_secp256k1_rows_are_not_silently_rejected():
    pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
    for backend in ("torch", "cpu"):
        bv = new_batch_verifier(backend, device="cpu")
        bv.add(pub, msg, sig)
        bv.add(b"\x02" + bytes(32), msg, sig)
        with pytest.raises(NotImplementedError):
            bv.verify()


def test_rows_with_bad_lengths_or_s_stay_in_the_batch_as_zero_rows():
    pub, msg, sig = testkit.adversarial_cases(seed=0)[0]
    big_s = sig[:32] + ref.L.to_bytes(32, "little")
    pub_rows, r_rows, s_rows, k_rows, valid = ed25519_torch.prepare_batch(
        [pub, pub[:31], pub], [msg] * 3, [sig, sig, big_s])
    assert valid.tolist() == [True, False, False]
    assert not pub_rows[1].any() and not r_rows[1].any() and not k_rows[1].any()
    assert not k_rows[2].any()  # k is only hashed for rows that stay valid
    got = ed25519_torch.verify_rows(*ed25519_torch.rows_to_device(
        (pub_rows, r_rows, s_rows, k_rows, valid), torch.device("cpu")))
    assert got.tolist() == [True, False, False]


def test_kernel_build_targets_sm90a_in_the_ignored_build_dir():
    assert kernels.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]
    path = kernels.library_path()
    assert path.parent == ROOT / "tendermint_tpu_torch" / "_build"
    assert "tendermint_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_library_name_hashes_headers_and_builds_only_cu(tmp_path, monkeypatch):
    """An edited csrc/*.cuh must give a new library (else a stale build in
    _build/ would be loaded), while nvcc compiles only the .cu files."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert [p.name for p in kernels._sources()] == [
        "ed25519_rlc.cu", "ed25519_rlc_f32.cu", "ed25519_verify.cu", "ed25519_verify_f32.cu",
        "ed25519_verify_f32_mma.cu", "ed25519_verify_packed.cu", "probes.cu"]
    first = kernels.library_path()
    assert first == kernels.library_path()
    header = csrc / "ed25519_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = kernels.library_path()
    assert second != first and second.parent == first.parent
    source = csrc / "ed25519_rlc.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert kernels.library_path() not in (first, second)


def test_build_runs_one_compiler_per_source_and_logs_its_seconds(tmp_path, monkeypatch):
    """build() with a stand-in nvcc that only writes its -o file: one
    compile per .cu, each source's seconds in the library's log, and no
    object or partial log left behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n'
                    'echo "ptxas info    : Used 1 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    out = kernels.build()
    log = out.with_suffix(".log").read_text()
    seconds = kernels.compile_seconds(log)
    assert sorted(seconds) == [p.name for p in kernels._sources()]
    assert all(t >= 0 for t in seconds.values())
    assert log.count("Used 1 registers") == len(seconds) + 1  # each compile and the link
    assert sorted(p.name for p in out.parent.iterdir()) == sorted([out.name, out.name[:-3] + ".log"])
    assert kernels.build() == out  # built once per set of sources


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    script = (ROOT / "chip_smoke.py").read_text()
    probe = tmp_path / "probe.py"
    probe.write_text("import torch\ntorch.cuda.is_available = lambda: False\n"
                     f"import runpy, sys\nsys.path.insert(0, {str(ROOT)!r})\n"
                     f"sys.argv = ['chip_smoke.py']\nrunpy.run_path({str(ROOT / 'chip_smoke.py')!r},"
                     " run_name='__main__')\n")
    assert "torch.cuda.is_available()" in script
    proc = subprocess.run([sys.executable, str(probe)], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_field_rows_and_decompress_rows_are_seeded():
    assert np.array_equal(testkit.field_rows(4, 8), testkit.field_rows(4, 8))
    assert np.array_equal(testkit.decompress_rows(4, 8), testkit.decompress_rows(4, 8))
