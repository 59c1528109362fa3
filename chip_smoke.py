#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of ``tendermint_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card (the
tensor-core f32 multiply ``fe_mul_mma`` on operands at its contract's
bounds and at the edges of its signed-byte split, every verify kernel
on the gauntlet and mixed batches, every RLC kernel and fold of every
layout at 128 and 10,000 rows), then drives the
port's commit-verification entry points at real validator-set sizes: a
128-validator commit, a 10,000-validator commit (MaxVotesCount) and a
blocksync window of 50 commits x 200 validators, first on the per-row
path in 5 x 51-bit limbs (``TM_CUDA_FIELD_IMPL=int64``:
``ed25519_verify``), then with ``TM_CUDA_RLC=1`` on the RLC
batch-equation path (``ed25519_rlc``, three launches, and the per-row
kernel as the exact fallback for a commit with a bad signature), then,
after the golden-batch gates on the card, that fallback in the layout
``auto`` resolves to (f32 with the tensor-core multiply), then under each
field layout, multiply and comb (``TM_CUDA_FIELD_IMPL`` = packed, f32,
int64, auto, ``TM_CUDA_FE_MXU`` and ``TM_CUDA_BASE_MXU``: every verify
kernel), and last the RLC path in every layout (``ed25519_rlc_packed``,
``ed25519_rlc_f32``, ``ed25519_rlc_f32_mma``), each with one fallback
commit; the folds, which the RLC path no longer needs, are held against
their plain versions at 157 lanes.  After the kernel timing, the probes
phase runs the port's device probes in-process
(``tendermint_tpu_torch/benchmarks``: ``roofline_probe --all``,
``kernel_bench --all`` and ``rlc_bench``), each probe kernel of
``csrc/probes.cu`` held against its plain version on the card.  Keys, signatures and the RLC part check's z are made from seeds.
Every phase prints one JSON line with the seconds it took (``phase_s``; a
``seconds`` line sums them); any mismatch, refused gate or exception
exits non-zero.  The last three lines are the card's
name and power limit, the kernels' table and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py        # needs one CUDA device; no arguments

It runs from a checkout of the repository, from any working directory:
the package ``tendermint_tpu_torch`` must lie beside the script.  Without
it, or without a CUDA device, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261017
TIMED_RUNS = 6  # end-to-end runs per entry point; p50 over these
KERNEL_RUNS = 20  # launches per kernel timing, each with its own CUDA events; p50
SLOW_KERNEL_RUNS = 3  # the same for a kernel whose first launch took over 20 ms
# plain versions timed over 3 runs; the others take a second or more: one run
PLAIN_TIMED_THRICE = ("fe_ops", "decompress", "fe_mul_mma")
PROBE_REPS = 5  # timed launches per device probe; p50
BENCH_REPS = 3  # timed launches per kernel_bench / rlc_bench kernel
# each probe kernel's entry in the kernels' table: its (probe, kind) at the
# original shape (ALL_CHAINS / ALL_PALLAS), and the TPU program it replaces
PROBE_KERNELS = {"pl_i32mul": (("pallas", "pl_i32mul"), "benchmarks/roofline_probe.py:417"),
                 "pl_femul8": (("pallas", "pl_femul8"), "benchmarks/roofline_probe.py:463"),
                 "op_chain": (("chain", "i32mul"), "benchmarks/roofline_probe.py:229"),
                 "fe_mul_chain": (("chain", "femul51"), "benchmarks/roofline_probe.py:229")}
LAYOUT_RUNS = 4  # end-to-end runs per field-layout setting (in turns); p50
MMA_LAYOUT_RUNS = 2  # the same for f32 with the tensor-core multiply (~200 ms a call)


PHASE_S: dict[str, float] = {}  # phase -> seconds since the previous phase ended
_PHASE_END = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds it took (since the last
    line, or the script's start)."""
    now = time.perf_counter()
    PHASE_S[phase] = now - _PHASE_END[0]
    _PHASE_END[0] = now
    print(json.dumps({"phase": phase, **fields, "phase_s": PHASE_S[phase]}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def p50(xs) -> float:
    return statistics.median(xs)


def sass_start(lib_path):
    """Starts cuobjdump on the built library in the background, writing its
    SASS beside the library; returns (process, that file)."""
    from torch.utils.cpp_extension import CUDA_HOME

    part = lib_path.with_suffix(".sass.part")
    with open(part, "w") as f:
        proc = subprocess.Popen([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                                 str(lib_path)], stdout=f, stderr=subprocess.DEVNULL)
    atexit.register(proc.kill)  # a failed check exits before the summary waits for it
    return proc, part


def sass_wait(proc, part) -> str:
    """The SASS ``sass_start``'s cuobjdump wrote, once it is done; the file
    becomes ``<library>.sass``, where ``roofline_probe.library_sass`` finds
    it."""
    if proc.wait(timeout=300) != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode})")
    return part.replace(part.with_suffix("")).read_text()


def sass_summary(sass: str) -> dict:
    """Per kernel of the built library: its SASS instruction count and the
    instructions that carry the limb products and the spills."""
    kinds = ("IMAD.WIDE.U32", "IMAD", "FFMA", "IMMA", "LDL", "STL")
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = dict.fromkeys(("instructions", *kinds), 0)
        elif name and line.strip().startswith("/*") and "*/" in line[line.index("/*") + 2:]:
            op = line.split("*/", 1)[1].split()
            op = op[1] if op and op[0].startswith("@") and len(op) > 1 else (op[0] if op else "")
            if not op or op.startswith("/*"):
                continue
            out[name]["instructions"] += 1
            for kind in kinds:
                if op == kind or op.startswith(kind + "."):
                    out[name][kind] += 1
                    break
    return out


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tendermint_tpu_torch")):
        print(f"chip_smoke: the package tendermint_tpu_torch is not beside {here}: run the "
              "script from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, here)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from tendermint_tpu_torch import testkit
    from tendermint_tpu_torch.benchmarks import card as bench_card
    from tendermint_tpu_torch.benchmarks import kernel_bench, rlc_bench, roofline_probe
    from tendermint_tpu_torch.crypto import ed25519 as ref
    from tendermint_tpu_torch.ops import ed25519_torch, fe25519, fe25519_f32, fe25519_packed, kernels
    from tendermint_tpu_torch.types.validator import CommitVerifyJob, batch_verify_commits

    dev = torch.device("cuda")
    # the plain versions' float32 matmuls (fe_mul_mxu) are exact only in
    # full float32: no TF32, in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench_card.nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock_mhz = bench_card.max_clock_mhz()
    pipe_per_s = bench_card.pipe_rates(dev)

    def timed_kernel_ms(fn) -> float:
        """p50 device time of one launch over KERNEL_RUNS launches (
        SLOW_KERNEL_RUNS for a kernel slower than 20 ms), each between its
        own pair of CUDA events.  The card first spins for ~50 ms, so every
        launch is queued before it runs and the events time the kernel,
        not the host's launch overhead."""
        first = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        first[0].record()
        fn()
        first[1].record()
        torch.cuda.synchronize()
        runs = SLOW_KERNEL_RUNS if first[0].elapsed_time(first[1]) > 20 else KERNEL_RUNS
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(runs)]
        torch.cuda._sleep(int(max_clock_mhz * 1e3 * 50))
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return p50([start.elapsed_time(end) for start, end in events])

    def timed_host(fn, runs: int):
        """(first run's result, p50 host-clock ms of fn() ending in a
        synchronise over `runs` runs)."""
        results, times = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            results.append(fn())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return results[0], p50(times)

    def timed_host_ms(fn, runs: int) -> float:
        return timed_host(fn, runs)[1]

    def bound_ms(kernel: str, n: int, nbytes: int, rlc_inputs=None,
                 high_muls: int = 0) -> tuple[float, str]:
        if kernel == "comb_select":  # a gather: bytes only
            ops_ms = 0.0
        else:  # the slowest pipe (an mma kernel: its FFMA squarings or its int8 mma)
            ops_ms = max(count / pipe_per_s[pipe] * 1e3 for pipe, count in
                         kernels.operations(kernel, n, rlc_inputs, high_muls).items())
        bytes_ms = nbytes / kernels.HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    # the per-row path in 5 x 51-bit limbs first, whatever the caller's
    # environment says; the other layouts and the comb come in phase 12
    os.environ.update(TM_CUDA_RLC="0", TM_CUDA_FIELD_IMPL="int64", TM_CUDA_BASE_MXU="0",
                      TM_CUDA_FE_MXU="auto")

    # -- 1. device and build ------------------------------------------------
    built_now = not kernels.library_path().exists()
    t0 = time.perf_counter()
    lib_path = kernels.build()
    build_s = time.perf_counter() - t0
    kernels.library()
    sass_job = sass_start(lib_path)  # read later: cuobjdump runs beside the checks
    build_log = lib_path.with_suffix(".log").read_text()
    ptxas = [line.strip() for line in build_log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0), sms=sms,
         max_sm_clock_mhz=max_clock_mhz, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, built_now=built_now, compile_s=kernels.compile_seconds(build_log),
         ptxas=ptxas)

    # -- 2. fe_ops against its plain version --------------------------------
    a = torch.from_numpy(testkit.field_rows(SEED, 4096)).to(dev)
    b = a.roll(1, dims=0).contiguous()
    got = fe25519.fe_ops_rows(a, b)
    want = fe25519.fe_ops(a, b)
    fe_err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
    check(fe_err == 0, "fe_ops differs from its plain version")
    a_np, mul_np = a.cpu().numpy(), got[0].cpu().numpy()
    for i in range(len(a_np) - len(testkit.field_edge_values()), len(a_np)):
        av = int.from_bytes(a_np[i].tobytes(), "little")
        bv = int.from_bytes(a_np[i - 1].tobytes(), "little")
        check(int.from_bytes(mul_np[i].tobytes(), "little") == av * bv % ref.P, "fe_ops edge row")
    emit("fe_ops", rows=len(a_np), max_abs_err=fe_err)

    # -- 3. decompress against its plain version ----------------------------
    enc = torch.from_numpy(testkit.decompress_rows(SEED, 4096)).to(dev)
    n_fixed = enc.shape[0] - 4096
    xy, ok = ed25519_torch.decompress_rows(enc)
    want_xy, want_ok = ed25519_torch.decompress_rows_plain(enc)
    dec_err = int((xy.int() - want_xy.int()).abs().max()) + int((ok != want_ok).sum())
    check(dec_err == 0, "decompress differs from its plain version")
    enc_np, ok_np = enc.cpu().numpy(), ok.cpu().numpy()
    for i in range(n_fixed):  # torsion encodings, y = 2, the base point
        check((ref.decode_point_zip215(enc_np[i].tobytes()) is not None) == bool(ok_np[i]),
              f"decompress row {i} vs the reference")
    emit("decompress", rows=len(enc_np), on_curve=int(ok_np.sum()), max_abs_err=dec_err)

    # -- 3b. fe_ops_packed, fe_ops_f32 and comb_select against their plain
    # versions: the field's and the layouts' edge rows, then the comb's
    # every (window, digit) pair (row j takes digit j in every window)
    edge_rows = np.concatenate([testkit.field_rows(SEED, 4096), testkit.layout_edge_rows()])
    a = torch.from_numpy(edge_rows).to(dev)
    b = a.roll(1, dims=0).contiguous()
    layout_fe_err = {}
    for name, module in (("fe_ops_packed", fe25519_packed), ("fe_ops_f32", fe25519_f32)):
        got = module.fe_ops_rows(a, b)
        err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, module.fe_ops(a, b)))
        check(err == 0, f"{name} differs from its plain version")
        mul_np = got[0].cpu().numpy()
        for i in range(len(edge_rows) - 30, len(edge_rows)):
            av = int.from_bytes(edge_rows[i].tobytes(), "little")
            bv = int.from_bytes(edge_rows[i - 1].tobytes(), "little")
            check(int.from_bytes(mul_np[i].tobytes(), "little") == av * bv % ref.P,
                  f"{name} edge row {i}")
        layout_fe_err[name] = err
    every_digit = torch.arange(256, dtype=torch.uint8, device=dev)[:, None].expand(256, 32)
    every_digit = every_digit.contiguous()
    comb_table = kernels.comb_table(dev)
    selected = ed25519_torch.comb_select_rows(every_digit)
    comb_err = int((selected.int() - ed25519_torch.comb_select_plain(every_digit, comb_table)
                    .int()).abs().max())
    check(comb_err == 0 and torch.equal(selected, comb_table.permute(1, 0, 2)),
          "comb_select differs from its plain version or the table")
    # the tensor-core multiply on raw limbs at its contract's bounds (every
    # sign pattern of +-153 x +-102, 133 x -132, 17,641 against ones) in
    # both argument orders, at the edges of its signed-byte split (limbs of
    # 127, -128 and 128 on each side) and seeded within the contract, limb
    # for limb against the plain matrix-unit product; the edge rows also
    # against the big-int product
    bound_a, bound_b = testkit.fe_mul_bound_limbs(SEED, 4096)
    byte_a, byte_b = testkit.fe_mul_byte_edge_limbs()
    n_bound = len(bound_a) - 4096
    x_np = np.concatenate([bound_a[:n_bound], bound_b[:n_bound], byte_a, byte_b,
                           bound_a[n_bound:]])
    y_np = np.concatenate([bound_b[:n_bound], bound_a[:n_bound], byte_b, byte_a,
                           bound_b[n_bound:]])
    n_edge = len(x_np) - 4096
    la, lb = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    got = fe25519_f32.fe_mul_mxu_rows(la, lb)
    mma_err = int((got - fe25519_f32.fe_mul_mxu(la, lb)).abs().max())
    check(mma_err == 0, "fe_mul_mma differs from the plain fe_mul_mxu")
    got_np = got.cpu().numpy()
    for i in range(n_edge):
        want = (fe25519_f32.int_from_limbs(x_np[i].astype(np.int64))
                * fe25519_f32.int_from_limbs(y_np[i].astype(np.int64)) % ref.P)
        check(fe25519_f32.int_from_limbs(got_np[i]) % ref.P == want, f"fe_mul_mma edge row {i}")
    layout_fe_err["fe_mul_mma"] = mma_err
    emit("layout-parts", rows=len(edge_rows), layout_edge_rows=len(testkit.layout_edge_values()),
         comb_pairs=32 * 256, fe_mul_mma_rows=len(x_np), fe_mul_mma_edge_rows=n_edge,
         fe_mul_mma_high_byte_rows=int(fe25519_f32.mxu_high_rows(la, lb).sum()),
         max_abs_err={**layout_fe_err, "comb_select": comb_err})

    # -- 4. adversarial verify ----------------------------------------------
    # every verify kernel against the reference on the gauntlet; against
    # their plain versions they meet the same kinds of row in phase 8,
    # where the mixed batches hold two gauntlet rows in every 8 (every case
    # of adversarial_cases, from another seed, at 10,000 rows)
    cases = testkit.adversarial_cases(SEED)
    pubs, msgs, sigs = ([c[i] for c in cases] for i in range(3))
    rows = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(pubs, msgs, sigs), dev)
    ref_v = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    check(any(ref_v) and not all(ref_v), "gauntlet lacks one outcome")
    # and on the part probes, rows whose R is made from s and k, so that a
    # wrong verdict names the part of the equation ([s]B, [k](-A)) at fault
    kinds, part_rows, part_want = testkit.part_probe_rows(SEED, n_each=8)
    part_rows = ed25519_torch.rows_to_device(part_rows, dev)
    gauntlet_err, part_err = {}, {}
    for (impl, base_mxu, fe_mxu), name in kernels.VERIFY_KERNELS.items():
        kernel_v = ed25519_torch.verify_rows(*rows, impl=impl, base_mxu=base_mxu,
                                             fe_mxu=fe_mxu).cpu().tolist()
        gauntlet_err[name] = sum(k != r for k, r in zip(kernel_v, ref_v))
        check(kernel_v == ref_v, f"adversarial verdicts differ from the reference ({name})")
        part_v = ed25519_torch.verify_rows(*part_rows, impl=impl, base_mxu=base_mxu,
                                           fe_mxu=fe_mxu).cpu().tolist()
        part_err[name] = sorted({k for k, g, w in zip(kinds, part_v, part_want) if g != w})
        check(not part_err[name], f"part probes {part_err[name]} wrong ({name})")
    emit("adversarial", rows=len(ref_v), accepted=sum(ref_v), differences=gauntlet_err,
         part_probe_rows=len(part_want), part_probes_wrong=part_err)

    # -- the main path: entry points only, counts reset before each call ----
    main_launches = dict.fromkeys(kernels.LAUNCHES, 0)

    def main_path(fn, kernel: str = "ed25519_verify"):
        """One entry-point call, which must launch `kernel` once and no
        other kernel."""
        kernels.reset_launches()
        try:
            fn()
        finally:
            counts = dict(kernels.LAUNCHES)
            for name, c in counts.items():
                main_launches[name] += c
            check({k: c for k, c in counts.items() if c} == {kernel: 1},
                  f"expected one {kernel} launch, counted {counts}")

    # -- 5. commit-128 ------------------------------------------------------
    keys = testkit.validator_keys(SEED, 128)
    vals = testkit.validator_set(keys)
    commit = testkit.signed_commit(keys, vals, height=1)
    bid = testkit.block_id_for(1)
    main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 1, commit))
    bad = 77
    commit.signatures[bad].signature = bytes([commit.signatures[bad].signature[0] ^ 1]) + \
        commit.signatures[bad].signature[1:]
    try:
        main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 1, commit))
        rejected = ""
    except ValueError as e:
        rejected = str(e)
    check(f"wrong signature (#{bad})" in rejected, f"corrupted commit: {rejected!r}")
    emit("commit-128", validators=128, accepted=True, corrupted_index=bad, rejected=rejected)

    # -- 6. commit-10k ------------------------------------------------------
    t0 = time.perf_counter()
    keys = testkit.validator_keys(SEED + 1, 10_000)
    vals = testkit.validator_set(keys)
    commit = testkit.signed_commit(keys, vals, height=2)
    setup_s = time.perf_counter() - t0
    bid = testkit.block_id_for(2)
    e2e = {}
    for name, call in (("verify_commit", vals.verify_commit),
                       ("verify_commit_light", vals.verify_commit_light)):
        times = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            main_path(lambda: call(testkit.CHAIN_ID, bid, 2, commit))
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[name] = p50(times)
    triples = ([v.pub_key.bytes_() for v in vals.validators],
               commit.vote_sign_bytes_batch(testkit.CHAIN_ID, range(10_000)),
               [cs.signature for cs in commit.signatures])
    sign_bytes_ms = timed_host_ms(
        lambda: commit.vote_sign_bytes_batch(testkit.CHAIN_ID, range(10_000)), TIMED_RUNS)
    prep_ms = timed_host_ms(lambda: ed25519_torch.prepare_batch(*triples), TIMED_RUNS)
    rows_10k = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(*triples), dev)
    table = kernels.base_table(dev)
    verify_ms = timed_kernel_ms(lambda: kernels.ed25519_verify(*rows_10k, table))
    check(bool(kernels.ed25519_verify(*rows_10k, table).all()), "10k rows not all valid")
    commit_10k = (vals, commit, bid)
    emit("commit-10k", validators=10_000, card=card, setup_s=setup_s,
         e2e_p50_ms=e2e, sign_bytes_p50_ms=sign_bytes_ms, host_prep_p50_ms=prep_ms,
         kernel_p50_ms=verify_ms,
         us_per_sig=e2e["verify_commit"] * 1e3 / 10_000, runs=TIMED_RUNS)

    # -- 7. blocksync-window ------------------------------------------------
    keys = testkit.validator_keys(SEED + 2, 200)
    vals = testkit.validator_set(keys)
    jobs = [CommitVerifyJob(vals, testkit.CHAIN_ID, testkit.block_id_for(h), h,
                            testkit.signed_commit(keys, vals, height=h)) for h in range(1, 51)]
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        main_path(lambda: batch_verify_commits(jobs))
        times.append((time.perf_counter() - t0) * 1e3)
    emit("blocksync-window", commits=50, validators=200, signatures=10_000, card=card,
         e2e_p50_ms=p50(times), us_per_sig=p50(times) * 1e3 / 10_000, runs=TIMED_RUNS)
    check(main_launches["ed25519_verify"] > 0, "the main path launched no ed25519_verify")

    # -- 8. every kernel against its plain version at N = 128 and 10,000 ---
    # Each verify kernel gets the commit-10k rows with gauntlet rows, flipped
    # R bits and changed messages spread through them (both verdicts in
    # every 8 rows, so in every block of threads); its error is the count
    # of rows where kernel and plain version disagree.
    mpubs, mmsgs, msigs, mwant = testkit.mixed_batch(*triples, seed=SEED + 5)
    mixed_rows = ed25519_torch.rows_to_device(
        ed25519_torch.prepare_batch(mpubs, mmsgs, msigs), dev)
    fe_rows = torch.from_numpy(testkit.field_rows(SEED + 3, 10_000)[:10_000]).to(dev)
    fe_b = fe_rows.roll(1, dims=0).contiguous()
    dec_rows = torch.from_numpy(testkit.decompress_rows(SEED + 4, 10_000)[:10_000]).to(dev)

    def disagreement(got, want) -> int:
        """Largest byte difference (or count of differing verdicts)."""
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return max(int((g.int() - w.int()).abs().sum() if g.dtype == torch.bool
                       else (g.int() - w.int()).abs().max()) for g, w in zip(got, want))

    mma_a, mma_b = (torch.from_numpy(x[:10_000]).to(dev)
                    for x in testkit.fe_mul_bound_limbs(SEED + 7, 10_000))
    shapes = {}
    for n in (128, 10_000):
        cut = tuple(t[:n] for t in mixed_rows)
        shapes[n] = {
            name: (lambda cut=cut, impl=impl, mxu=mxu, fe_mxu=fe_mxu: kernels.verify(
                       impl, mxu, fe_mxu)(*cut, ed25519_torch.kernel_table(impl, mxu, dev)),
                   lambda cut=cut, impl=impl, mxu=mxu, fe_mxu=fe_mxu: ed25519_torch.verify_core(
                       *cut, impl=impl, base_mxu=mxu, fe_mxu=fe_mxu),
                   n * (4 * 32 + 2) + ed25519_torch.kernel_table(impl, mxu, dev).nbytes)
            for (impl, mxu, fe_mxu), name in kernels.VERIFY_KERNELS.items()}
        shapes[n]["fe_mul_mma"] = (lambda n=n: kernels.fe_mul_mma(mma_a[:n], mma_b[:n]),
                                   lambda n=n: fe25519_f32.fe_mul_mxu(mma_a[:n], mma_b[:n]),
                                   n * 3 * 51 * 4)
        shapes[n].update({
            "fe_ops": (lambda n=n: kernels.fe_ops(fe_rows[:n], fe_b[:n]),
                       lambda n=n: fe25519.fe_ops(fe_rows[:n], fe_b[:n]),
                       n * 5 * 32),
            "decompress": (lambda n=n: kernels.decompress(dec_rows[:n]),
                           lambda n=n: ed25519_torch.decompress_rows_plain(dec_rows[:n]),
                           n * (32 + 64 + 1)),
            "comb_select": (lambda n=n: kernels.comb_select(mixed_rows[2][:n], comb_table),
                            lambda n=n: ed25519_torch.comb_select_plain(mixed_rows[2][:n],
                                                                        comb_table),
                            n * (32 + 32 * 128) + comb_table.nbytes),
        })
        for name, module in (("fe_ops_packed", fe25519_packed), ("fe_ops_f32", fe25519_f32)):
            shapes[n][name] = (lambda n=n, m=module: m.fe_ops_rows(fe_rows[:n], fe_b[:n]),
                               lambda n=n, m=module: m.fe_ops(fe_rows[:n], fe_b[:n]),
                               n * 5 * 32)
    # the one PyTorch call that computes a part kernel's function, timed
    # beside it (the port never calls it): comb_select's selection is an
    # advanced-indexing gather of the same byte table, on the s rows
    # widened to int64 beforehand
    windows = torch.arange(32, device=dev)
    s_index = mixed_rows[2].long()
    library_calls = {("comb_select", n): (lambda n=n: comb_table[windows, s_index[:n]])
                     for n in (128, 10_000)}
    # fe_mul_mma's contraction is one float64 matmul of the [N, 2601] limb
    # product tensor (made beforehand) against the incidence matrix; its
    # columns, carried, must be the kernel's limbs
    inc64 = fe25519_f32.const("INC", dev).double()
    mma_prod = (mma_a.double()[:, :, None] * mma_b.double()[:, None, :]).reshape(-1, 51 * 51)
    library_calls.update({("fe_mul_mma", n): (lambda n=n: torch.matmul(mma_prod[:n], inc64))
                          for n in (128, 10_000)})
    library_equal = {"comb_select": lambda lib, got: torch.equal(lib, got),
                     "fe_mul_mma": lambda lib, got: torch.equal(
                         fe25519_f32.fe_carry(lib.float(), rounds=6), got)}
    timing = {}
    errs = {**gauntlet_err, **layout_fe_err, "fe_ops": fe_err, "decompress": dec_err,
            "comb_select": comb_err, "fe_mul_mma": mma_err}
    for n, kernels_at_n in shapes.items():
        for name, (kernel_fn, plain_fn, nbytes) in kernels_at_n.items():
            got = kernel_fn()
            want, plain_ms = timed_host(plain_fn, 3 if name in PLAIN_TIMED_THRICE else 1)
            err = disagreement(got, want)
            check(err == 0, f"{name} differs from its plain version at N = {n}")
            errs[name] = max(errs[name], err)
            if name in kernels.VERIFY_KERNELS.values():
                check(got.cpu().tolist() == mwant[:n], f"mixed verdicts at N = {n}")
                check(any(mwant[:n]) and not all(mwant[:n]), "mixed batch lacks one outcome")
            # fe_mul_mma's rows whose Toeplitz operand needs its high byte
            # (133 x -132) cost a second set of mma
            high_muls = (int(fe25519_f32.mxu_high_rows(mma_a[:n], mma_b[:n]).sum())
                         if name == "fe_mul_mma" else 0)
            bound, bound_by = bound_ms(name, n, nbytes, high_muls=high_muls)
            library_fn, library_ms = library_calls.get((name, n)), None
            if library_fn is not None:
                check(library_equal[name](library_fn(), got),
                      f"{name}'s library call differs at N = {n}")
                library_ms = timed_kernel_ms(library_fn)
            timing[(name, n)] = {"ms": timed_kernel_ms(kernel_fn), "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                                 "library_ms": library_ms}
    emit("timing", card=card, pipe_per_s=pipe_per_s, kernel_runs=KERNEL_RUNS,
         slow_kernel_runs=SLOW_KERNEL_RUNS,
         mixed_rejected=mwant.count(False),
         kernels={f"{name}@{n}": t for (name, n), t in timing.items()})

    # -- 8b. the device probes (tendermint_tpu_torch/benchmarks) ------------
    # roofline_probe --all's work in-process: the census, every chain and
    # Pallas probe at its original shape and at eight waves (each probe's
    # first launch held against its plain version on the card, exactly;
    # pl_femul8, femul8 and femul51 also mod p against big-int on a sample
    # of lanes),
    # the roofline line on the verify kernels' times of phase 8; then
    # kernel_bench --all and rlc_bench on their default batch.  The probe
    # kernels' launches are counted over this phase alone: the probe path.
    sass = sass_wait(*sass_job)
    kernels.reset_launches()
    probe_lines = roofline_probe.run_all(
        reps=PROBE_REPS, sass=sass,
        verify_ms={name: timing[(name, 10_000)]["ms"]
                   for name in roofline_probe.ROOFLINE_KERNELS.values()})
    bench_lines = [kernel_bench.run_bench(impl, reps=BENCH_REPS, base_mxu=base_mxu,
                                          fe_mxu=fe_mxu)
                   for impl, base_mxu, fe_mxu in sorted(kernels.VERIFY_KERNELS)]
    bench_lines.append(rlc_bench.run_rlc_bench(reps=BENCH_REPS))
    probe_launches = {name: kernels.LAUNCHES[name] for name in PROBE_KERNELS}
    check(all(probe_launches.values()), f"the probe path left a kernel unlaunched: "
                                        f"{probe_launches}")
    for line in probe_lines + bench_lines:
        print(json.dumps(line), flush=True)
    check(all(line.get("agree", True) for line in probe_lines), "a field-multiply probe "
          "disagrees with big-int arithmetic")
    check(all(line["verify_ok"] for line in bench_lines[:-1]), "kernel_bench: wrong verdicts")
    check(bench_lines[-1]["rlc_ok"] and bench_lines[-1]["mixed_verdicts_exact"],
          "rlc_bench: the RLC path is wrong")
    probe_timing = {}
    for name, ((probe, kind), _) in PROBE_KERNELS.items():
        errs[name] = max(line["max_abs_err"] for line in probe_lines
                         if line["probe"] in ("chain", "pallas")
                         and roofline_probe.PROBE_KINDS[line["kind"]][0] == name)
        lines = [line for line in probe_lines
                 if line["probe"] == probe and line["kind"] == kind]
        first, widest = lines[0], lines[-1]
        probe_timing[name] = {
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes" if first["pipe"] == "bytes" else "operations",
            "pipe": first["pipe"], "pipe_share": first["pipe_share"],
            "sass_bound_ms": first["sass_bound_ms"], "max_abs_err": errs[name],
            "library_ms": None, "probe": f"{probe} {kind} {first['rows']}x{first['lanes']} "
                                         f"chain {first['chain']}",
            "saturating": {k: widest[k] for k in ("rows", "lanes", "ms", "bound_ms", "pipe",
                                                  "pipe_share", "sass_bound_ms", "waves")}}
    emit("probes", card=card, launches=probe_launches, probes=len(probe_lines),
         benches=len(bench_lines))

    # -- 9. the RLC kernels of every layout against their plain versions.
    # The RLC equation's inputs with z from the seed, on the mixed rows
    # (both verdicts in every 8 rows: the equation fails) and on the honest
    # commit-10k rows (it holds).  Each layout's kernel lanes (one per
    # window, three launches) and the plain version's in that layout (the
    # JAX program's partition) must sum to the same point, with the same
    # prevalid and the same decision; the error is the count of such
    # disagreements.  The folds, off the RLC path since its kernels write
    # 64 lanes, are held against the plain fold on random lanes of each
    # layout, byte for byte in canonical coordinates: 157 lanes (what
    # 10,000 rows gave the earlier kernels) and 2.
    prepared = {"mixed": ed25519_torch.prepare_batch(mpubs, mmsgs, msigs),
                "honest": ed25519_torch.prepare_batch(*triples)}
    rlc_inputs = {}
    for n in (128, 10_000):
        for label, rows_np in prepared.items():
            rows, c_row = testkit.rlc_rows(tuple(a[:n] for a in rows_np), seed=SEED + 6)
            rlc_inputs[(label, n)] = (ed25519_torch.rows_to_device(rows, dev), c_row)

    def lane_sum(lanes, impl) -> tuple:
        int_from_limbs = ed25519_torch._FIELDS[impl].int_from_limbs
        coords = [c.cpu().numpy() for c in lanes.astuple()]
        total = ref.IDENTITY
        for i in range(coords[0].shape[0]):
            total = ref.pt_add(total, tuple(int_from_limbs(c[i]) % ref.P for c in coords))
        return total

    def stage_ms(fn) -> list[float]:
        """p50 device ms of each of an RLC call's launches, over 3 calls."""
        runs = []
        for _ in range(3):
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(kernels.RLC_STAGES + 1)]
            fn(events)
            torch.cuda.synchronize()
            runs.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
        return [p50(col) for col in zip(*runs)]

    lane_bytes = {impl: 4 * limbs * torch.empty(0, dtype=dtype).element_size()
                  for impl, (dtype, limbs) in kernels.LANE_LIMBS.items()}
    rlc_plain_ms = {}
    for (impl, fe_mxu), name in kernels.RLC_KERNELS.items():
        errs.setdefault(name, 0)
        rlc_work = {}
        for (label, n), (cut, c_row) in rlc_inputs.items():
            raw, prevalid = kernels.rlc(impl, fe_mxu)(*cut)
            check(raw.shape[0] == kernels.rlc_lanes(n), f"{name} lanes at N = {n}")
            got = ed25519_torch.lanes_to_pt(raw, impl)
            (want, want_prevalid), plain_ms = timed_host(
                lambda cut=cut: ed25519_torch.verify_core_rlc(*cut, impl=impl, fe_mxu=fe_mxu), 1)
            if label == "mixed":
                rlc_plain_ms[(name, n)] = plain_ms
                rlc_work[n] = (cut[2].cpu().numpy(), cut[3].cpu().numpy(),
                               prevalid.cpu().numpy())
            decision = ed25519_torch.finalize_rlc(got, c_row, impl)
            err = (int((prevalid != want_prevalid).sum())
                   + int(not ref.pt_equal(lane_sum(got, impl), lane_sum(want, impl)))
                   + int(decision != ed25519_torch.finalize_rlc(want, c_row, impl)))
            check(err == 0, f"{name} differs from its plain version ({label}, N = {n})")
            check(decision == (label == "honest"), f"{name} decision on {label} rows at N = {n}")
            errs[name] = max(errs[name], err)
        for n in (128, 10_000):
            rows = rlc_inputs[("mixed", n)][0]
            timing[(name, n)] = {
                "ms": timed_kernel_ms(lambda rows=rows: kernels.rlc(impl, fe_mxu)(*rows)),
                "stage_ms": stage_ms(lambda events, rows=rows: kernels.rlc(impl, fe_mxu)(
                    *rows, stage_events=events)),
                "plain_ms": rlc_plain_ms[(name, n)], "max_abs_err": errs[name],
                "library_ms": None, "lanes": kernels.rlc_lanes(n),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(
                    name, n, n * (3 * 32 + 16 + 1 + 1) + kernels.rlc_lanes(n)
                    * lane_bytes[impl], rlc_work[n])))}
    for impl, fold in kernels.FOLD_KERNELS.items():
        errs.setdefault(fold, 0)
        for n, p in ((128, 2), (10_000, 157)):
            raw = torch.from_numpy(testkit.random_lanes(SEED + 8 + p, p, impl)).to(dev)
            if impl == "int64":
                raw = raw.to(torch.int64)
            folded = kernels.rlc_fold(raw)
            plain_fold, plain_ms = timed_host(lambda raw=raw: ed25519_torch._pt_reduce_to_lanes(
                ed25519_torch.lanes_to_pt(raw, impl), kernels.RLC_MAX_LANES, impl), 3)
            got_rows = ed25519_torch.pt_rows(ed25519_torch.lanes_to_pt(folded, impl), impl)
            err = int((got_rows.int() - ed25519_torch.pt_rows(plain_fold, impl).int()).abs().max())
            check(err == 0 and len(folded) == kernels.reduced_width(p, kernels.RLC_MAX_LANES),
                  f"{fold} differs from its plain version ({p} lanes)")
            errs[fold] = max(errs[fold], err)
            # 2 lanes: the copy a fold of 2 lanes is
            timing[(fold, n)] = {
                "ms": timed_kernel_ms(lambda raw=raw: kernels.rlc_fold(raw)),
                "plain_ms": plain_ms, "max_abs_err": errs[fold], "library_ms": None, "lanes": p,
                **dict(zip(("bound_ms", "bound_by"), bound_ms(
                    fold, p, (p + kernels.reduced_width(p, kernels.RLC_MAX_LANES))
                    * lane_bytes[impl])))}
    rlc_err = max(errs[name] for name in kernels.RLC_KERNELS.values())
    fold_err = max(errs[name] for name in kernels.FOLD_KERNELS.values())
    scalars_ms = timed_host_ms(
        lambda: ed25519_torch.prepare_rlc_scalars(*prepared["honest"][2:]), TIMED_RUNS)
    honest_rows, honest_c = rlc_inputs[("honest", 10_000)]
    honest_lanes = ed25519_torch.verify_rows_rlc(*honest_rows)[0]
    finalize_ms = timed_host_ms(lambda: ed25519_torch.finalize_rlc(honest_lanes, honest_c),
                                TIMED_RUNS)
    rlc_names = (*kernels.RLC_KERNELS.values(), *kernels.FOLD_KERNELS.values())
    emit("rlc-parts", card=card, max_abs_err=rlc_err, fold_max_abs_err=fold_err,
         mixed_rejected=mwant.count(False), rlc_scalars_p50_ms=scalars_ms,
         finalize_p50_ms=finalize_ms, finalize_lanes=honest_lanes.x.shape[0],
         kernels={f"{name}@{n}": timing[(name, n)] for name in rlc_names for n in (128, 10_000)})

    # -- 10. the RLC path through the entry points (TM_CUDA_RLC=1) ---------
    def rlc_main_path(fn, fallback: str | None = None,
                      layout: tuple[str, bool] = ("int64", False)):
        """One entry-point call on the RLC path: the three launches of the
        RLC kernel of `layout` (field layout, tensor-core multiply), one
        launch of the per-row kernel `fallback` where the equation fails,
        and no other kernel."""
        kernels.reset_launches()
        before = dict(ed25519_torch.RLC_STATS)
        try:
            fn()
        finally:
            counts = dict(kernels.LAUNCHES)
            for name, c in counts.items():
                main_launches[name] += c
            want = {kernels.RLC_KERNELS[layout]: kernels.RLC_STAGES}
            if fallback:
                want[fallback] = 1
            check({k: c for k, c in counts.items() if c} == want,
                  f"RLC path: expected {want}, counted {counts}")
            moved = "fallback" if fallback else "pass"
            check(ed25519_torch.RLC_STATS[moved] == before[moved] + 1
                  and sum(ed25519_torch.RLC_STATS.values()) == sum(before.values()) + 1,
                  f"RLC_STATS {before} -> {ed25519_torch.RLC_STATS}")

    vals, commit, bid = commit_10k
    light_signatures = vals.total_voting_power() * 2 // 3 // 10 + 1  # power 10 each, to +2/3
    # per-row and RLC calls in turns (per-row, RLC, RLC, per-row, ...), so
    # both paths meet the host in the same state; p50 of TIMED_RUNS each
    calls = (("verify_commit", lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit)),
             ("verify_commit_light",
              lambda: vals.verify_commit_light(testkit.CHAIN_ID, bid, 2, commit)),
             ("blocksync-window", lambda: batch_verify_commits(jobs)))
    per_row_e2e, rlc_e2e = {}, {}
    for name, call in calls:
        times = {"0": [], "1": []}
        for i in range(TIMED_RUNS):
            for setting in ("0", "1") if i % 2 == 0 else ("1", "0"):
                os.environ["TM_CUDA_RLC"] = setting
                t0 = time.perf_counter()
                if setting == "1":
                    rlc_main_path(call)
                else:
                    main_path(call)
                times[setting].append((time.perf_counter() - t0) * 1e3)
        per_row_e2e[name], rlc_e2e[name] = p50(times["0"]), p50(times["1"])
    bad = 4321
    good_sig = commit.signatures[bad].signature
    commit.signatures[bad].signature = bytes([good_sig[0] ^ 1]) + good_sig[1:]
    rejected = {}
    for setting in ("0", "1"):
        os.environ["TM_CUDA_RLC"] = setting
        try:
            if setting == "1":
                t0 = time.perf_counter()
                rlc_main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit),
                              fallback="ed25519_verify")
            else:
                main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit))
            rejected[setting] = ""
        except ValueError as e:
            rejected[setting] = str(e)
            if setting == "1":
                rlc_e2e["verify_commit_fallback"] = (time.perf_counter() - t0) * 1e3
    check(f"wrong signature (#{bad})" in rejected["1"] and rejected["0"] == rejected["1"],
          f"corrupted commit-10k with and without RLC: {rejected}")
    os.environ["TM_CUDA_RLC"] = "0"
    emit("rlc-main-path", card=card, validators=10_000, light_signatures=light_signatures,
         rlc_e2e_p50_ms=rlc_e2e, per_row_e2e_p50_ms=per_row_e2e,
         rlc_kernel_p50_ms={"ed25519_rlc": timing[("ed25519_rlc", 10_000)]["ms"]},
         per_row_kernel_p50_ms=verify_ms, corrupted_index=bad, rejected=rejected["1"],
         rlc_stats=dict(ed25519_torch.RLC_STATS), runs=TIMED_RUNS)
    check(all(main_launches[k] > 0 for k in ("ed25519_verify", "ed25519_rlc")),
          f"the main path left a kernel unlaunched: {main_launches}")
    commit.signatures[bad].signature = good_sig

    # -- 11. the golden-batch gates on the card -----------------------------
    # Each layout's kernel, each comb and f32's tensor-core multiply (alone
    # and with the comb) runs the JAX package's golden batch once; a refusal
    # fails the script.  Then `auto` resolves by its ladder: f32 with the
    # tensor-core multiply, the JAX ladder's top rung, with TM_CUDA_FE_MXU
    # at its default; packed with TM_CUDA_FE_MXU=0 (the ladder before).
    ed25519_torch.OPTIN_STATE.clear()
    t0 = time.perf_counter()
    gates = {f"{flag}:{impl}": ed25519_torch._optin_safe(flag, impl, dev)
             for flag, impl in (("impl", "packed"), ("base_mxu", "int64"), ("base_mxu", "f32"),
                                ("fe_mxu", "f32"), ("base_mxu+fe_mxu", "f32"))}
    gate_s = time.perf_counter() - t0
    check(all(gates.values()), f"a golden gate refused on the card: {gates}")
    os.environ.update(TM_CUDA_FIELD_IMPL="auto", TM_CUDA_FE_MXU="0")
    auto_before = ed25519_torch.default_impl(dev)
    os.environ["TM_CUDA_FE_MXU"] = "auto"
    auto_impl = ed25519_torch.default_impl(dev)
    auto_fe_mxu = ed25519_torch._resolve_optin(auto_impl, dev)[1]
    check(auto_impl == "f32" and auto_fe_mxu and auto_before == "packed",
          f"auto resolved to {auto_impl} (fe_mxu {auto_fe_mxu}), {auto_before} with it off")
    emit("gates", card=card, passed=gates, seconds=gate_s, auto_resolved_to=auto_impl,
         auto_fe_mxu=auto_fe_mxu, auto_with_fe_mxu_off=auto_before)

    # -- 11b. the RLC fallback in the layout users get by default ----------
    # TM_CUDA_RLC=1 under `auto` (the gates above are memoised, so no
    # golden run is counted here): commit-10k with one bad signature fails
    # the equation in f32 with the tensor-core multiply, and that layout's
    # per-row kernel decides it with the per-row path's error.
    vals, commit, bid = commit_10k
    commit.signatures[bad].signature = bytes([good_sig[0] ^ 1]) + good_sig[1:]
    os.environ["TM_CUDA_RLC"] = "1"
    auto_fallback = kernels.VERIFY_KERNELS[(auto_impl, False, auto_fe_mxu)]
    t0 = time.perf_counter()
    try:
        rlc_main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit),
                      fallback=auto_fallback, layout=(auto_impl, auto_fe_mxu))
        auto_rejected = ""
    except ValueError as e:
        auto_rejected = str(e)
    auto_fallback_ms = (time.perf_counter() - t0) * 1e3
    check(auto_rejected == rejected["0"],
          f"RLC fallback under auto: {auto_rejected!r}, per-row path: {rejected['0']!r}")
    os.environ["TM_CUDA_RLC"] = "0"
    commit.signatures[bad].signature = good_sig
    emit("rlc-auto-fallback", card=card, validators=10_000, auto_resolved_to=auto_impl,
         rlc_kernel=kernels.RLC_KERNELS[(auto_impl, auto_fe_mxu)],
         fallback_kernel=auto_fallback, corrupted_index=bad, rejected=auto_rejected,
         e2e_ms=auto_fallback_ms, rlc_stats=dict(ed25519_torch.RLC_STATS))

    # -- 12. the main path under each field layout, multiply and comb -------
    # commit-10k verify_commit and the blocksync window, each call launching
    # exactly the kernel its TM_CUDA_FIELD_IMPL / TM_CUDA_BASE_MXU /
    # TM_CUDA_FE_MXU select; the settings in turns, LAYOUT_RUNS rounds, p50
    # each (MMA_LAYOUT_RUNS rounds for the forced tensor-core settings).
    # auto with TM_CUDA_FE_MXU=0 is the ladder before the f32 rung (packed),
    # auto with the default the ladder now (f32, tensor cores).
    settings = (("int64", "0", "auto"), ("packed", "0", "auto"), ("f32", "0", "0"),
                ("f32", "1", "0"), ("f32", "0", "auto"), ("f32", "1", "auto"),
                ("int64", "1", "auto"), ("auto", "0", "0"), ("auto", "0", "auto"))

    def kernel_for(impl: str, mxu: str, fe_mxu: str) -> str:
        resolved = (auto_before if fe_mxu == "0" else auto_impl) if impl == "auto" else impl
        return kernels.VERIFY_KERNELS[(resolved, mxu == "1" and resolved != "packed",
                                       fe_mxu != "0" and resolved == "f32")]

    vals, commit, bid = commit_10k
    calls = (("verify_commit", lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit)),
             ("blocksync-window", lambda: batch_verify_commits(jobs)))
    layout_times = {"/".join(k): {name: [] for name, _ in calls} for k in settings}
    for r in range(LAYOUT_RUNS):
        for impl, mxu, fe_mxu in settings[r % len(settings):] + settings[:r % len(settings)]:
            if impl == "f32" and fe_mxu != "0" and r >= MMA_LAYOUT_RUNS:
                continue
            os.environ.update(TM_CUDA_FIELD_IMPL=impl, TM_CUDA_BASE_MXU=mxu, TM_CUDA_FE_MXU=fe_mxu)
            for name, call in calls:
                t0 = time.perf_counter()
                main_path(call, kernel_for(impl, mxu, fe_mxu))
                layout_times["/".join((impl, mxu, fe_mxu))][name].append(
                    (time.perf_counter() - t0) * 1e3)
    os.environ.update(TM_CUDA_FIELD_IMPL="int64", TM_CUDA_BASE_MXU="0", TM_CUDA_FE_MXU="auto")
    emit("layout-main-path", card=card, validators=10_000, auto_resolved_to=auto_impl,
         auto_with_fe_mxu_off=auto_before,
         kernels={"/".join(k): kernel_for(*k) for k in settings},
         e2e_p50_ms={k: {name: p50(t) for name, t in v.items()} for k, v in layout_times.items()},
         kernel_p50_ms={name: timing[(name, 10_000)]["ms"]
                        for name in kernels.VERIFY_KERNELS.values()},
         runs=LAYOUT_RUNS, mma_runs=MMA_LAYOUT_RUNS)

    # -- 13. the RLC path in every layout through the entry points ---------
    # TM_CUDA_RLC=1 with TM_CUDA_FIELD_IMPL = packed, f32 (FFMA and tensor-
    # core multiply) and auto: commit-10k verify_commit (and, for packed,
    # the window; the f32 kernels' window calls take what their commit
    # calls take), in turns, each call making its layout's RLC kernel's
    # three launches; then in each layout one commit-10k with a bad
    # signature, which falls back to that layout's per-row kernel with the
    # per-row path's error.
    rlc_settings = (("packed", "auto"), ("f32", "0"), ("f32", "auto"), ("auto", "auto"))

    def rlc_layout(impl: str, fe_mxu: str) -> tuple[str, bool]:
        resolved = auto_impl if impl == "auto" else impl
        return resolved, fe_mxu != "0" and resolved == "f32"

    os.environ["TM_CUDA_RLC"] = "1"
    rlc_calls = {k: calls if k[0] == "packed" else calls[:1] for k in rlc_settings}
    rlc_layout_times = {"/".join(k): {name: [] for name, _ in rlc_calls[k]} for k in rlc_settings}
    for r in range(LAYOUT_RUNS // 2):
        for impl, fe_mxu in rlc_settings[r:] + rlc_settings[:r]:
            os.environ.update(TM_CUDA_FIELD_IMPL=impl, TM_CUDA_FE_MXU=fe_mxu)
            for name, call in rlc_calls[(impl, fe_mxu)]:
                t0 = time.perf_counter()
                rlc_main_path(call, layout=rlc_layout(impl, fe_mxu))
                rlc_layout_times["/".join((impl, fe_mxu))][name].append(
                    (time.perf_counter() - t0) * 1e3)
    commit.signatures[bad].signature = bytes([good_sig[0] ^ 1]) + good_sig[1:]
    rlc_fallback = {}
    for impl, fe_mxu in rlc_settings:
        os.environ.update(TM_CUDA_FIELD_IMPL=impl, TM_CUDA_FE_MXU=fe_mxu)
        layout = rlc_layout(impl, fe_mxu)
        fallback = kernels.VERIFY_KERNELS[(layout[0], False, layout[1])]
        t0 = time.perf_counter()
        try:
            rlc_main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit),
                          fallback=fallback, layout=layout)
            got = ""
        except ValueError as e:
            got = str(e)
        check(got == rejected["0"], f"RLC fallback in {impl}/{fe_mxu}: {got!r}")
        rlc_fallback["/".join((impl, fe_mxu))] = {
            "rlc_kernel": kernels.RLC_KERNELS[layout], "fallback_kernel": fallback,
            "e2e_ms": (time.perf_counter() - t0) * 1e3}
    commit.signatures[bad].signature = good_sig
    os.environ.update(TM_CUDA_RLC="0", TM_CUDA_FIELD_IMPL="int64", TM_CUDA_FE_MXU="auto")
    emit("rlc-layout-main-path", card=card, validators=10_000,
         kernels={"/".join(k): kernels.RLC_KERNELS[rlc_layout(*k)] for k in rlc_settings},
         e2e_p50_ms={k: {name: p50(t) for name, t in v.items()}
                     for k, v in rlc_layout_times.items()},
         fallback=rlc_fallback, rlc_stats=dict(ed25519_torch.RLC_STATS),
         runs=LAYOUT_RUNS // 2)
    path_kernels = (*kernels.VERIFY_KERNELS.values(), *kernels.RLC_KERNELS.values())
    check(all(main_launches[k] > 0 for k in path_kernels),
          f"the main path left a kernel unlaunched: {main_launches}")

    # -- the kernels' table and the result ----------------------------------
    csrc = "tendermint_tpu_torch/csrc/"
    sources = {"ed25519_verify": "ed25519_verify.cu", "fe_ops": "ed25519_verify.cu",
               "decompress": "ed25519_verify.cu", "ed25519_verify_comb": "base_comb.cuh",
               "ed25519_verify_f32_comb": "base_comb.cuh", "comb_select": "base_comb.cuh",
               "ed25519_verify_packed": "ed25519_verify_packed.cu",
               "fe_ops_packed": "ed25519_verify_packed.cu",
               "ed25519_verify_f32": "ed25519_verify_f32.cu", "fe_ops_f32": "ed25519_verify_f32.cu",
               "ed25519_verify_f32_mma": "fe_f32_mma.cuh",
               "ed25519_verify_f32_mma_comb": "fe_f32_mma.cuh", "fe_mul_mma": "fe_f32_mma.cuh",
               **dict.fromkeys((*kernels.RLC_KERNELS.values(), *kernels.FOLD_KERNELS.values()),
                               "ed25519_rlc.cuh"),
               **dict.fromkeys(PROBE_KERNELS, "probes.cu")}
    replaces = {"ed25519_verify": "tendermint_tpu/ops/ed25519_jax.py:529",
                "ed25519_verify_comb": "tendermint_tpu/ops/ed25519_jax.py:328",
                "ed25519_verify_packed": "tendermint_tpu/ops/ed25519_jax.py:529",
                "ed25519_verify_f32": "tendermint_tpu/ops/ed25519_jax.py:529",
                "ed25519_verify_f32_comb": "tendermint_tpu/ops/ed25519_jax.py:328",
                "ed25519_verify_f32_mma": "tendermint_tpu/ops/fe25519_f32.py:202",
                "ed25519_verify_f32_mma_comb": "tendermint_tpu/ops/fe25519_f32.py:202",
                "fe_ops": "tendermint_tpu/ops/fe25519.py:108",
                "fe_ops_packed": "tendermint_tpu/ops/fe25519_packed.py:167",
                "fe_ops_f32": "tendermint_tpu/ops/fe25519_f32.py:221",
                "fe_mul_mma": "tendermint_tpu/ops/fe25519_f32.py:202",
                "decompress": "tendermint_tpu/ops/ed25519_jax.py:217",
                "comb_select": "tendermint_tpu/ops/ed25519_jax.py:328",
                "ed25519_rlc": "tendermint_tpu/ops/ed25519_jax.py:422",
                "ed25519_rlc_packed": "tendermint_tpu/ops/ed25519_jax.py:701",
                "ed25519_rlc_f32": "tendermint_tpu/ops/ed25519_jax.py:701",
                "ed25519_rlc_f32_mma": "tendermint_tpu/ops/ed25519_jax.py:701",
                "rlc_fold": "tendermint_tpu/ops/ed25519_jax.py:390",
                "rlc_fold_packed": "tendermint_tpu/ops/ed25519_jax.py:390",
                "rlc_fold_f32": "tendermint_tpu/ops/ed25519_jax.py:390",
                **{name: at for name, (_, at) in PROBE_KERNELS.items()}}
    table_line = [{"name": name, "route": "cuda", "source": csrc + sources[name],
                   "replaces": replaces[name],
                   "launches": probe_launches.get(name, main_launches[name]),
                   **{k: v for k, v in (probe_timing.get(name) or timing[(name, 10_000)]).items()
                      if k != "lanes"},
                   "max_abs_err": errs[name]}
                  for name in replaces]
    summary = sass_summary(sass)
    # the kernels on the tensor-core multiply (element ff_t<1>, and the part
    # kernel fe_mul_mma, which is fe_mul alone): its IMMA, the IMAD that
    # would show products formed outside them, and the spills
    emit("sass", kernels=summary,
         tensor_core={name: {k: counts[k] for k in ("instructions", "IMAD", "IMMA", "LDL", "STL")}
                      for name, counts in summary.items()
                      if "ff_tILi1E" in name or "fe_mul_mma" in name})
    emit("seconds", build_s=build_s, total_s=sum(PHASE_S.values()), phases=dict(PHASE_S))
    print(card, flush=True)
    print(json.dumps({"kernels": table_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
