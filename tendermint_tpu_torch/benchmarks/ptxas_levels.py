"""The tensor-core source at every ptxas optimisation level: builds
``csrc/ed25519_verify_f32_mma.cu`` with the library's own nvcc command
(``kernels.compile_command``) plus ``-Xptxas -O<level>``, one build per
level, all at once, and holds each build's kernels to the reference:

- ``ed25519_verify_f32_mma`` and ``ed25519_verify_f32_mma_comb`` on the
  golden batch, the gauntlet (``testkit.adversarial_cases``) and the part
  probes (``testkit.part_probe_rows``: rows whose R is made from the
  scalars, so a wrong verdict names the part of the equation that went
  wrong), at 64 rows and tiled to ``--batch`` rows;
- ``fe_mul_mma`` on the contract's bound rows and the byte-edge rows, in
  both argument orders, limb for limb against the plain ``fe_mul_mxu``.

It also reads each build's SASS (cuobjdump) for the one hazard that the
verdicts may not show: a warp-collective instruction (IMMA, VOTE,
WARPSYNC, SHFL), or a call of a function that reaches one, inside a region
that ptxas opens with BSSY for a possibly diverged warp.  Then it times
the three kernels of every build on ``--batch`` rows with CUDA events, the
levels in turn and then in reverse, so that each level's median comes from
both halves of the run.

A verdict that differs between levels points at undefined behaviour in the
source (a warp-collective operation reached by a diverged warp, a shared
word read before the lane that writes it has passed a ``__syncwarp``) or
at a fault of ptxas; the library itself is built at ptxas's default level.

Usage:
    python -m tendermint_tpu_torch.benchmarks.ptxas_levels [--levels 0,1,2,3]
        [--batch 10000] [--reps 5]

Prints one JSON line per level:
  {"level": L, "ok": true, "checks": {"golden/ed25519_verify_f32_mma":
   {"wrong": 0, "of": 8}, ...}, "divergent_collectives": {kernel: [...]},
   "ms": {"ed25519_verify_f32_mma": p50, ...},
   "compile_s": ..., "platform": "gpu", "device": <card>}
then {"ptxas": <version>, "nvidia_smi": <name, power limit>, "ok": all
levels right} and exits 1 if a level got a verdict or a limb wrong, or
has a collective in a divergent region.
Without a CUDA device it raises: the builds need nvcc and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import testkit
from ..crypto import ed25519 as ref
from ..ops import ed25519_torch, fe25519_f32, kernels
from .card import device_times_ms, nvidia_smi, platform, resolve

SOURCE = "ed25519_verify_f32_mma.cu"
VERIFY = ("ed25519_verify_f32_mma", "ed25519_verify_f32_mma_comb")
LEVELS = (0, 1, 2, 3)


def level_command(nvcc: str, src: Path, obj: Path, level: int) -> list[str]:
    """The library's compile command for `src` with ptxas at `level`."""
    return [*kernels.compile_command(nvcc, src, obj), "-Xptxas", f"-O{level}"]


def build_levels(levels) -> dict[int, tuple[Path, float]]:
    """{level: (its library, compile and link seconds)}, one nvcc per level
    at once; a build for the same sources and level is reused."""
    h = hashlib.sha256()
    for src in kernels._hashed_sources():
        h.update(src.name.encode() + src.read_bytes())
    out_dir = kernels.BUILD_DIR / "ptxas_levels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    libs = {lvl: out_dir / f"O{lvl}-{h.hexdigest()[:16]}.so" for lvl in levels}
    start = time.perf_counter()
    jobs = {lvl: subprocess.Popen(level_command(nvcc, kernels.CSRC / SOURCE,
                                                lib.with_suffix(".o"), lvl),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for lvl, lib in libs.items() if not lib.exists()}
    seconds = {lvl: 0.0 for lvl in levels}
    for lvl, proc in jobs.items():
        obj = libs[lvl].with_suffix(".o")
        log = proc.communicate()[0]
        if proc.returncode == 0:
            tmp = libs[lvl].with_suffix(".tmp")
            link = subprocess.run([nvcc, *kernels.ARCH_FLAGS, "-shared", "-o", str(tmp),
                                   str(obj)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode == 0:
                os.replace(tmp, libs[lvl])
        obj.unlink(missing_ok=True)
        seconds[lvl] = time.perf_counter() - start
        if not libs[lvl].exists():
            raise RuntimeError(f"nvcc failed at ptxas -O{lvl}:\n{log[-4000:]}")
        libs[lvl].with_suffix(".log").write_text(log)
    return {lvl: (libs[lvl], seconds[lvl]) for lvl in levels}


COLLECTIVE = re.compile(r"\b(IMMA|HMMA|VOTE|WARPSYNC|SHFL|MATCH|REDUX)\b")


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{kernel: [(address, instruction)]} from cuobjdump -sass; a kernel's
    listing holds the functions it calls after its own code."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def divergent_collectives(body: list[tuple[int, str]]) -> list[str]:
    """The collective instructions of one kernel's listing, and the calls
    of its functions that reach one, that lie inside a BSSY region (from
    the BSSY to its reconvergence address): places where the warp may be
    diverged.  Functions are split at the call targets; one is collective
    if it holds a collective instruction or calls a collective one."""
    calls = {}
    for a, ins in body:
        m = re.search(r"CALL\.\S+ (0x[0-9a-f]+)", ins)
        if m:
            calls[a] = int(m.group(1), 16)
    starts = sorted({body[0][0], *calls.values()}) if body else []
    owner = lambda a: max(x for x in starts if x <= a)
    collective = {owner(a) for a, ins in body if COLLECTIVE.search(ins)}
    grown = True
    while grown:
        grown = False
        for a, target in calls.items():
            if target in collective and owner(a) not in collective:
                collective.add(owner(a))
                grown = True
    regions = [(a, int(m.group(1), 16)) for a, ins in body
               for m in [re.search(r"BSSY B\d+, (0x[0-9a-f]+)", ins)] if m]
    return [f"{a:#x} {ins}" for a, ins in body
            if (COLLECTIVE.search(ins) or calls.get(a) in collective)
            and any(lo <= a < hi for lo, hi in regions)]


def sass_hazards(lib: Path) -> dict[str, list[str]]:
    """{kernel: divergent_collectives} for every kernel of a build."""
    sass = subprocess.run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {name: divergent_collectives(body) for name, body in sass_functions(sass).items()}


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in VERIFY:
        getattr(lib, f"tm_{name}").argtypes = [p, p, p, p, p, p, p, i, p]
        getattr(lib, f"tm_{name}").restype = i
    lib.tm_fe_mul_mma.argtypes = [p, p, p, i, p]
    lib.tm_fe_mul_mma.restype = i
    return lib


def _call(lib, name: str, *tensors, n: int) -> None:
    err = getattr(lib, f"tm_{name}")(*(t.data_ptr() for t in tensors), n,
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def verify_launch(lib, name: str, rows, table):
    """A closure that launches verify kernel `name` of `lib` on `rows`
    (CUDA tensors) and returns its verdicts tensor."""
    out = torch.empty(rows[0].shape[0], dtype=torch.bool, device=rows[0].device)

    def run():
        _call(lib, name, *rows, table, out, n=out.shape[0])
        return out
    return run


def fe_mul_launch(lib, a, b):
    out = torch.empty_like(a)

    def run():
        _call(lib, "fe_mul_mma", a, b, out, n=a.shape[0])
        return out
    return run


def inputs(dev: torch.device, batch: int):
    """(verdict batches {label: (rows on dev, wanted, kinds or None)},
    fe_mul operands and their plain products, the batch timed)."""
    golden, golden_want = ed25519_torch._golden_batch()
    cases = testkit.adversarial_cases(0)
    gauntlet = ed25519_torch.prepare_batch(*map(list, zip(*cases)))
    kinds, parts, parts_want = testkit.part_probe_rows(seed=5, n_each=8)
    reps = -(-batch // len(parts_want))
    tiled = tuple(np.ascontiguousarray(np.concatenate([c] * reps)[:batch]) for c in parts)
    to_dev = lambda rows: ed25519_torch.rows_to_device(rows, dev)
    batches = {"golden": (to_dev(golden), golden_want, None),
               "gauntlet": (to_dev(gauntlet), [ref.verify(*c) for c in cases], None),
               "parts": (to_dev(parts), parts_want, kinds),
               f"parts{batch}": (to_dev(tiled), (parts_want * reps)[:batch], kinds * reps)}
    a, b = testkit.fe_mul_bound_limbs(seed=21, n_random=64)
    ea, eb = testkit.fe_mul_byte_edge_limbs()
    fa, fb = np.concatenate([a, b, ea, eb]), np.concatenate([b, a, eb, ea])
    want = fe25519_f32.fe_mul_mxu(torch.from_numpy(fa), torch.from_numpy(fb)).numpy()
    ta, tb = testkit.fe_mul_bound_limbs(seed=22, n_random=batch)
    timed = tuple(torch.from_numpy(np.ascontiguousarray(x[-batch:])).to(dev) for x in (ta, tb))
    return batches, (torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev), want), timed


def check(lib, batches, fe_rows, tables) -> dict:
    """{check: {"wrong": rows, "of": rows, ...}} of one build."""
    out = {}
    for label, (rows, want, kinds) in batches.items():
        for name in VERIFY:
            got = verify_launch(lib, name, rows, tables[name])().cpu().tolist()
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            entry = {"wrong": len(bad), "of": len(want)}
            if bad:
                entry["first_wrong"] = bad[:8]
                if kinds:
                    entry["wrong_kinds"] = sorted({kinds[i] for i in bad})
            out[f"{label}/{name}"] = entry
    a, b, want = fe_rows
    got = fe_mul_launch(lib, a, b)().cpu().numpy()
    out["edges/fe_mul_mma"] = {"wrong": int((got != want).any(axis=1).sum()), "of": len(want)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", default=",".join(map(str, LEVELS)))
    ap.add_argument("--batch", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve(None)
    levels = [int(x) for x in args.levels.split(",")]
    built = build_levels(levels)
    batches, fe_rows, timed = inputs(dev, args.batch)
    tables = {VERIFY[0]: ed25519_torch.kernel_table("f32", False, dev),
              VERIFY[1]: ed25519_torch.kernel_table("f32", True, dev)}
    libs = {lvl: load(path) for lvl, (path, _) in built.items()}
    results = {lvl: check(lib, batches, fe_rows, tables) for lvl, lib in libs.items()}
    times = {lvl: {name: [] for name in (*VERIFY, "fe_mul_mma")} for lvl in levels}
    rows = batches[f"parts{args.batch}"][0]
    for order in (levels, levels[::-1]):
        for lvl in order:
            for name in VERIFY:
                times[lvl][name] += device_times_ms(verify_launch(libs[lvl], name, rows,
                                                                  tables[name]), args.reps)
            times[lvl]["fe_mul_mma"] += device_times_ms(fe_mul_launch(libs[lvl], *timed),
                                                        args.reps)
    hazards = {lvl: sass_hazards(path) for lvl, (path, _) in built.items()}
    all_ok = True
    for lvl in levels:
        ok = (all(c["wrong"] == 0 for c in results[lvl].values())
              and not any(hazards[lvl].values()))
        all_ok &= ok
        print(json.dumps({"level": lvl, "ok": ok, "checks": results[lvl],
                          "divergent_collectives": hazards[lvl], "batch": args.batch,
                          "ms": {k: statistics.median(v) for k, v in times[lvl].items()},
                          "compile_s": built[lvl][1], **platform(dev)}), flush=True)
    ptxas = subprocess.run([str(Path(kernels._nvcc()).with_name("ptxas")), "--version"],
                           capture_output=True, text=True).stdout.strip().splitlines()[-2]
    print(json.dumps({"ptxas": ptxas, "nvidia_smi": nvidia_smi("name,power.limit"),
                      "ok": all_ok}), flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
