"""``benchmarks/ptxas_levels``: the tensor-core source built at every ptxas
optimisation level, each build's verify kernels and ``fe_mul_mma`` held to
the reference.  The check itself needs the card and skips here; the CPU
tests hold the builds' commands and the tool's refusal without a card."""

import pytest
import torch

from tendermint_tpu_torch.benchmarks import ptxas_levels
from tendermint_tpu_torch.ops import kernels


@pytest.mark.cuda
def test_every_ptxas_level_gives_the_reference_verdicts(capsys):
    """Each level's ed25519_verify_f32_mma and _comb on the golden batch,
    the gauntlet and the part probes (at 64 and 512 rows), and its
    fe_mul_mma on the contract's edge rows, all exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rc = ptxas_levels.main(["--batch", "512", "--reps", "1"])
    assert rc == 0, capsys.readouterr().out


def _stand_in_nvcc(tmp_path, monkeypatch):
    """An nvcc that records its arguments and only writes its -o file."""
    nvcc = tmp_path / "nvcc"
    record = tmp_path / "args"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {record}\n'
                    'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    return nvcc, record


def test_each_level_builds_with_the_library_command_and_its_ptxas_level(tmp_path, monkeypatch):
    """A level's compile is the library's command for the tensor-core
    source with ``-Xptxas -O<level>`` after it (the last -O wins), then a
    link; a second call reuses the builds."""
    nvcc, record = _stand_in_nvcc(tmp_path, monkeypatch)
    built = ptxas_levels.build_levels([1, 3])
    assert sorted(built) == [1, 3] and all(path.exists() for path, _ in built.values())
    calls = [line.split() for line in record.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    assert len(compiles) == 2 and len(calls) == 4
    assert sorted(args[-1] for args in compiles) == ["-O1", "-O3"]  # they run at once
    for args in compiles:
        level, obj = int(args[-1][2:]), args[args.index("-o") + 1]
        src = kernels.CSRC / ptxas_levels.SOURCE
        assert [str(nvcc), *args] == [*kernels.compile_command(str(nvcc), src, obj),
                                      "-Xptxas", f"-O{level}"]
    ptxas_levels.build_levels([1, 3])
    assert len(record.read_text().splitlines()) == 4
    assert not list(built[1][0].parent.glob("*.o"))


def test_the_levels_tool_needs_a_card(monkeypatch):
    """Without a CUDA device the tool raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ptxas_levels, "build_levels", lambda levels: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptxas_levels.main(["--levels", "3"])


_SASS = """
        Function : kernel_a
        /*0000*/                   CALL.REL.NOINC 0x100 ;
        /*0010*/                   BSSY B0, 0x60 ;
        /*0020*/               @P0 BRA 0x50 ;
        /*0030*/                   CALL.REL.NOINC 0x200 ;
        /*0040*/                   CALL.REL.NOINC 0x300 ;
        /*0050*/                   BSYNC B0 ;
        /*0060*/                   CALL.REL.NOINC 0x200 ;
        /*0070*/                   EXIT ;
        /*0100*/                   IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0110*/                   RET.REL.NODEC R20 0x0 ;
        /*0200*/                   CALL.REL.NOINC 0x100 ;
        /*0210*/                   RET.REL.NODEC R22 0x0 ;
        /*0300*/                   FFMA R1, R2, R3, R4 ;
        /*0310*/                   RET.REL.NODEC R24 0x0 ;
        Function : kernel_b
        /*0000*/                   BSSY B1, 0x30 ;
        /*0010*/                   VOTE.ANY R0, PT, P1 ;
        /*0020*/                   BSYNC B1 ;
        /*0030*/                   WARPSYNC 0xffffffff ;
        /*0040*/                   EXIT ;
"""


def test_the_sass_check_flags_collectives_in_a_divergent_region():
    """A call, in a BSSY region, of a function that reaches an IMMA
    through another is flagged, as is a vote there; the same call after
    the reconvergence point, a call of a plain function in the region and
    a WARPSYNC outside it are not."""
    functions = ptxas_levels.sass_functions(_SASS)
    assert sorted(functions) == ["kernel_a", "kernel_b"]
    assert len(functions["kernel_a"]) == 14
    assert ptxas_levels.divergent_collectives(functions["kernel_a"]) == [
        "0x30 CALL.REL.NOINC 0x200"]
    assert ptxas_levels.divergent_collectives(functions["kernel_b"]) == [
        "0x10 VOTE.ANY R0, PT, P1"]
