#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of ``tendermint_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card, then
drives the port's commit-verification entry points at real validator-set
sizes: a 128-validator commit, a 10,000-validator commit (MaxVotesCount)
and a blocksync window of 50 commits x 200 validators, first on the
per-row path in 5 x 51-bit limbs (``TM_CUDA_FIELD_IMPL=int64``:
``ed25519_verify``), then with ``TM_CUDA_RLC=1`` on the RLC
batch-equation path (``ed25519_rlc`` + ``rlc_fold``, and the per-row
kernel as the exact fallback for a commit with a bad signature), then,
after the golden-batch gates on the card, that fallback in the layout
``auto`` resolves to, then under each field layout and the comb
(``TM_CUDA_FIELD_IMPL`` = packed, f32, int64, auto, with and without
``TM_CUDA_BASE_MXU=1``: ``ed25519_verify_packed``,
``ed25519_verify_f32``, ``ed25519_verify_f32_comb``,
``ed25519_verify_comb``).  Keys, signatures and the RLC part check's z
are made from seeds.  Every phase prints one JSON line; any mismatch,
refused gate or exception exits non-zero.  The last three lines are the
card's name and power limit, the kernels' table and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py        # needs one CUDA device; no arguments

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261017
TIMED_RUNS = 12  # end-to-end runs per entry point; p50 over these
KERNEL_RUNS = 20  # launches per kernel timing, each with its own CUDA events; p50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# plain versions timed over 3 runs; the others take seconds at 10,000 rows: one run
PLAIN_TIMED_THRICE = ("ed25519_verify", "fe_ops", "decompress")
# per SM per clock, compute capability 9.0: 32-bit integer multiply-add,
# FP32 fused multiply-add
PIPE_PER_SM_PER_CLK = {"imad": 64, "ffma": 128}
INT8_TENSOR_OPS_PER_S = 1.979e15  # H100 SXM dense int8 (data sheet)
LAYOUT_RUNS = 6  # end-to-end runs per field-layout setting (in turns); p50


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def p50(xs) -> float:
    return statistics.median(xs)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_summary(lib_path) -> dict:
    """Per kernel of the built library: its SASS instruction count and the
    instructions that carry the limb products and the spills (cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
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
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1


    from tendermint_tpu_torch import testkit
    from tendermint_tpu_torch.crypto import ed25519 as ref
    from tendermint_tpu_torch.ops import ed25519_torch, fe25519, fe25519_f32, fe25519_packed, kernels
    from tendermint_tpu_torch.types.validator import CommitVerifyJob, batch_verify_commits

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    pipe_per_s = {pipe: sms * rate * max_clock_mhz * 1e6
                  for pipe, rate in PIPE_PER_SM_PER_CLK.items()}

    def timed_kernel_ms(fn) -> float:
        """p50 device time of one launch over KERNEL_RUNS launches, each
        between its own pair of CUDA events.  The card first spins for
        ~50 ms, so every launch is queued before it runs and the events
        time the kernel, not the host's launch overhead."""
        fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(KERNEL_RUNS)]
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

    def bound_ms(kernel: str, n: int, nbytes: int) -> tuple[float, str]:
        if kernel == "comb_select":  # 32 one-hot [n, 256] x [256, 128] int8 products
            ops_ms = n * 32 * 256 * 128 * 2 / INT8_TENSOR_OPS_PER_S * 1e3
        else:
            count, pipe = kernels.operations(kernel, n)
            ops_ms = count / pipe_per_s[pipe] * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    # the per-row path in 5 x 51-bit limbs first, whatever the caller's
    # environment says; the other layouts and the comb come in phase 12
    os.environ.update(TM_CUDA_RLC="0", TM_CUDA_FIELD_IMPL="int64", TM_CUDA_BASE_MXU="0")

    # -- 1. device and build ------------------------------------------------
    built_now = not kernels.library_path().exists()
    t0 = time.perf_counter()
    lib_path = kernels.build()
    build_s = time.perf_counter() - t0
    kernels.library()
    ptxas = [line.strip() for line in lib_path.with_suffix(".log").read_text().splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0), sms=sms,
         max_sm_clock_mhz=max_clock_mhz, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, built_now=built_now, ptxas=ptxas, sass=sass_summary(lib_path))

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
    check(comb_err == 0 and torch.equal(selected, comb_table.permute(2, 0, 1)),
          "comb_select differs from its plain version or the table")
    emit("layout-parts", rows=len(edge_rows), layout_edge_rows=len(testkit.layout_edge_values()),
         comb_pairs=32 * 256, max_abs_err={**layout_fe_err, "comb_select": comb_err})

    # -- 4. adversarial verify ----------------------------------------------
    cases = testkit.adversarial_cases(SEED)
    pubs, msgs, sigs = ([c[i] for c in cases] for i in range(3))
    rows = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(pubs, msgs, sigs), dev)
    ref_v = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    check(any(ref_v) and not all(ref_v), "gauntlet lacks one outcome")
    gauntlet_err = {}
    for (impl, base_mxu), name in kernels.VERIFY_KERNELS.items():
        kernel_v = ed25519_torch.verify_rows(*rows, impl=impl, base_mxu=base_mxu).cpu().tolist()
        plain_v = ed25519_torch.verify_core(*rows, impl=impl, base_mxu=base_mxu).cpu().tolist()
        gauntlet_err[name] = sum(k != p for k, p in zip(kernel_v, plain_v))
        check(kernel_v == plain_v == ref_v, f"adversarial verdicts differ ({name})")
    emit("adversarial", rows=len(ref_v), accepted=sum(ref_v), max_abs_err=gauntlet_err)

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

    shapes = {}
    for n in (128, 10_000):
        cut = tuple(t[:n] for t in mixed_rows)
        shapes[n] = {
            name: (lambda cut=cut, impl=impl, mxu=mxu: kernels.verify(impl, mxu)(
                       *cut, ed25519_torch.kernel_table(impl, mxu, dev)),
                   lambda cut=cut, impl=impl, mxu=mxu: ed25519_torch.verify_core(
                       *cut, impl=impl, base_mxu=mxu),
                   n * (4 * 32 + 2) + ed25519_torch.kernel_table(impl, mxu, dev).nbytes)
            for (impl, mxu), name in kernels.VERIFY_KERNELS.items()}
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
    library_calls = {("comb_select", n): (lambda n=n: comb_table.permute(2, 0, 1)[
        s_index[:n], windows]) for n in (128, 10_000)}
    timing = {}
    errs = {**gauntlet_err, **layout_fe_err, "fe_ops": fe_err, "decompress": dec_err,
            "comb_select": comb_err}
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
            bound, bound_by = bound_ms(name, n, nbytes)
            library_fn, library_ms = library_calls.get((name, n)), None
            if library_fn is not None:
                check(torch.equal(library_fn(), got), f"{name}'s library call differs at N = {n}")
                library_ms = timed_kernel_ms(library_fn)
            timing[(name, n)] = {"ms": timed_kernel_ms(kernel_fn), "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                                 "library_ms": library_ms}
    emit("timing", card=card, pipe_per_s=pipe_per_s, kernel_runs=KERNEL_RUNS,
         mixed_rejected=mwant.count(False),
         kernels={f"{name}@{n}": t for (name, n), t in timing.items()})

    # -- 9. ed25519_rlc and rlc_fold against their plain version -----------
    # The RLC equation's inputs with z from the seed, on the mixed rows
    # (both verdicts in every 8 rows: the equation fails) and on the honest
    # commit-10k rows (it holds).  The kernels' lanes (one per 64 rows,
    # folded to <= 128) and the plain version's (the JAX program's
    # partition) must sum to the same point, with the same prevalid and
    # the same decision; the error is the count of such disagreements.
    # rlc_fold gets the lanes ed25519_rlc wrote and must give the plain
    # fold's lanes, byte for byte in canonical coordinates.
    prepared = {"mixed": ed25519_torch.prepare_batch(mpubs, mmsgs, msigs),
                "honest": ed25519_torch.prepare_batch(*triples)}
    rlc_inputs = {}
    for n in (128, 10_000):
        for label, rows_np in prepared.items():
            rows, c_row = testkit.rlc_rows(tuple(a[:n] for a in rows_np), seed=SEED + 6)
            rlc_inputs[(label, n)] = (ed25519_torch.rows_to_device(rows, dev), c_row)

    def lane_sum(lanes) -> tuple:
        coords = [c.cpu().numpy() for c in lanes.astuple()]
        total = ref.IDENTITY
        for i in range(coords[0].shape[0]):
            total = ref.pt_add(total, tuple(fe25519.int_from_limbs(c[i]) % ref.P for c in coords))
        return total

    rlc_err = fold_err = 0
    for (label, n), (cut, c_row) in rlc_inputs.items():
        raw, prevalid = kernels.ed25519_rlc(*cut)
        check(raw.shape[0] == kernels.rlc_lanes(n), f"ed25519_rlc lanes at N = {n}")
        folded = kernels.rlc_fold(raw) if raw.shape[0] > kernels.RLC_MAX_LANES else raw
        got = ed25519_torch.lanes_to_pt(folded)
        want, want_prevalid = ed25519_torch.verify_core_rlc(*cut)
        decision = ed25519_torch.finalize_rlc(got, c_row)
        err = (int((prevalid != want_prevalid).sum())
               + int(not ref.pt_equal(lane_sum(got), lane_sum(want)))
               + int(decision != ed25519_torch.finalize_rlc(want, c_row)))
        check(err == 0, f"ed25519_rlc differs from its plain version ({label}, N = {n})")
        check(decision == (label == "honest"), f"RLC decision on {label} rows at N = {n}")
        rlc_err = max(rlc_err, err)
        if folded is not raw:
            plain_fold = ed25519_torch._pt_reduce_to_lanes(ed25519_torch.lanes_to_pt(raw),
                                                           kernels.RLC_MAX_LANES)
            err = int((ed25519_torch.pt_rows(got).int()
                       - ed25519_torch.pt_rows(plain_fold).int()).abs().max())
            check(err == 0, f"rlc_fold differs from its plain version ({label}, N = {n})")
            fold_err = max(fold_err, err)
    errs.update(ed25519_rlc=rlc_err, rlc_fold=fold_err)

    lane_bytes = 4 * 5 * 8
    for n in (128, 10_000):
        rows = rlc_inputs[("mixed", n)][0]
        raw = kernels.ed25519_rlc(*rows)[0]
        p = raw.shape[0]
        parts = {
            "ed25519_rlc": (lambda rows=rows: kernels.ed25519_rlc(*rows),
                            lambda rows=rows: ed25519_torch.verify_core_rlc(*rows),
                            "ed25519_rlc", n, n * (3 * 32 + 16 + 1) + p * lane_bytes),
            # at 128 rows (2 lanes) the main path does not fold; the time
            # is that of the copy a fold of 2 lanes is
            "rlc_fold": (lambda raw=raw: kernels.rlc_fold(raw),
                         lambda raw=raw: ed25519_torch._pt_reduce_to_lanes(
                             ed25519_torch.lanes_to_pt(raw), kernels.RLC_MAX_LANES),
                         "rlc_fold", p,
                         (p + kernels.reduced_width(p, kernels.RLC_MAX_LANES)) * lane_bytes),
        }
        for name, (kernel_fn, plain_fn, kernel, count, nbytes) in parts.items():
            _, plain_ms = timed_host(plain_fn, 3)
            bound, bound_by = bound_ms(kernel, count, nbytes)
            timing[(name, n)] = {"ms": timed_kernel_ms(kernel_fn), "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by,
                                 "max_abs_err": errs[name], "library_ms": None, "lanes": p}
    scalars_ms = timed_host_ms(
        lambda: ed25519_torch.prepare_rlc_scalars(*prepared["honest"][2:]), TIMED_RUNS)
    honest_rows, honest_c = rlc_inputs[("honest", 10_000)]
    honest_lanes = ed25519_torch.verify_rows_rlc(*honest_rows)[0]
    finalize_ms = timed_host_ms(lambda: ed25519_torch.finalize_rlc(honest_lanes, honest_c),
                                TIMED_RUNS)
    emit("rlc-parts", card=card, max_abs_err=rlc_err, fold_max_abs_err=fold_err,
         mixed_rejected=mwant.count(False), rlc_scalars_p50_ms=scalars_ms,
         finalize_p50_ms=finalize_ms, finalize_lanes=honest_lanes.x.shape[0],
         kernels={f"{name}@{n}": timing[(name, n)]
                  for name in ("ed25519_rlc", "rlc_fold") for n in (128, 10_000)})

    # -- 10. the RLC path through the entry points (TM_CUDA_RLC=1) ---------
    def rlc_main_path(fn, signatures: int, fallback: str | None = None):
        """One entry-point call on the RLC path: one ed25519_rlc launch, one
        rlc_fold above 128 lanes, one launch of the per-row kernel
        `fallback` where the equation fails, and no other kernel."""
        kernels.reset_launches()
        before = dict(ed25519_torch.RLC_STATS)
        try:
            fn()
        finally:
            counts = dict(kernels.LAUNCHES)
            for name, c in counts.items():
                main_launches[name] += c
            want = {"ed25519_rlc": 1}
            if kernels.rlc_lanes(signatures) > kernels.RLC_MAX_LANES:
                want["rlc_fold"] = 1
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
    calls = (("verify_commit", lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit),
              10_000),
             ("verify_commit_light",
              lambda: vals.verify_commit_light(testkit.CHAIN_ID, bid, 2, commit),
              light_signatures),
             ("blocksync-window", lambda: batch_verify_commits(jobs), 10_000))
    per_row_e2e, rlc_e2e = {}, {}
    for name, call, signatures in calls:
        times = {"0": [], "1": []}
        for i in range(TIMED_RUNS):
            for setting in ("0", "1") if i % 2 == 0 else ("1", "0"):
                os.environ["TM_CUDA_RLC"] = setting
                t0 = time.perf_counter()
                if setting == "1":
                    rlc_main_path(call, signatures)
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
                              10_000, fallback="ed25519_verify")
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
         rlc_kernel_p50_ms={"ed25519_rlc": timing[("ed25519_rlc", 10_000)]["ms"],
                            "rlc_fold": timing[("rlc_fold", 10_000)]["ms"]},
         per_row_kernel_p50_ms=verify_ms, corrupted_index=bad, rejected=rejected["1"],
         rlc_stats=dict(ed25519_torch.RLC_STATS), runs=TIMED_RUNS)
    check(all(main_launches[k] > 0 for k in ("ed25519_verify", "ed25519_rlc", "rlc_fold")),
          f"the main path left a kernel unlaunched: {main_launches}")
    commit.signatures[bad].signature = good_sig

    # -- 11. the golden-batch gates on the card -----------------------------
    # Each layout's kernel and each comb runs the JAX package's golden batch
    # once; a refusal fails the script.  Then `auto` resolves by its ladder.
    ed25519_torch.OPTIN_STATE.clear()
    t0 = time.perf_counter()
    gates = {f"{flag}:{impl}": ed25519_torch._optin_safe(flag, impl, dev)
             for flag, impl in (("impl", "packed"), ("base_mxu", "int64"), ("base_mxu", "f32"))}
    gate_s = time.perf_counter() - t0
    check(all(gates.values()), f"a golden gate refused on the card: {gates}")
    os.environ["TM_CUDA_FIELD_IMPL"] = "auto"
    auto_impl = ed25519_torch.default_impl(dev)
    emit("gates", card=card, passed=gates, seconds=gate_s, auto_resolved_to=auto_impl)

    # -- 11b. the RLC fallback in the layout users get by default ----------
    # TM_CUDA_RLC=1 under `auto` (the gates above are memoised, so no
    # golden run is counted here): commit-10k with one bad signature fails
    # the equation, and the per-row kernel of the resolved layout decides
    # it with the per-row path's error.
    vals, commit, bid = commit_10k
    commit.signatures[bad].signature = bytes([good_sig[0] ^ 1]) + good_sig[1:]
    os.environ["TM_CUDA_RLC"] = "1"
    auto_fallback = kernels.VERIFY_KERNELS[(auto_impl, False)]
    t0 = time.perf_counter()
    try:
        rlc_main_path(lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit),
                      10_000, fallback=auto_fallback)
        auto_rejected = ""
    except ValueError as e:
        auto_rejected = str(e)
    auto_fallback_ms = (time.perf_counter() - t0) * 1e3
    check(auto_rejected == rejected["0"],
          f"RLC fallback under auto: {auto_rejected!r}, per-row path: {rejected['0']!r}")
    os.environ["TM_CUDA_RLC"] = "0"
    commit.signatures[bad].signature = good_sig
    emit("rlc-auto-fallback", card=card, validators=10_000, auto_resolved_to=auto_impl,
         fallback_kernel=auto_fallback, corrupted_index=bad, rejected=auto_rejected,
         e2e_ms=auto_fallback_ms, rlc_stats=dict(ed25519_torch.RLC_STATS))

    # -- 12. the main path under each field layout and the comb -------------
    # commit-10k verify_commit and the blocksync window, each call launching
    # exactly the kernel its TM_CUDA_FIELD_IMPL / TM_CUDA_BASE_MXU select;
    # the settings in turns, LAYOUT_RUNS rounds, p50 each.
    settings = (("int64", "0"), ("packed", "0"), ("f32", "0"), ("f32", "1"), ("int64", "1"),
                ("auto", "0"))

    def kernel_for(impl: str, mxu: str) -> str:
        resolved = auto_impl if impl == "auto" else impl
        return kernels.VERIFY_KERNELS[(resolved, mxu == "1" and resolved != "packed")]

    vals, commit, bid = commit_10k
    calls = (("verify_commit", lambda: vals.verify_commit(testkit.CHAIN_ID, bid, 2, commit)),
             ("blocksync-window", lambda: batch_verify_commits(jobs)))
    layout_times = {f"{impl}/{mxu}": {name: [] for name, _ in calls} for impl, mxu in settings}
    for r in range(LAYOUT_RUNS):
        for impl, mxu in settings[r % len(settings):] + settings[:r % len(settings)]:
            os.environ.update(TM_CUDA_FIELD_IMPL=impl, TM_CUDA_BASE_MXU=mxu)
            for name, call in calls:
                t0 = time.perf_counter()
                main_path(call, kernel_for(impl, mxu))
                layout_times[f"{impl}/{mxu}"][name].append((time.perf_counter() - t0) * 1e3)
    os.environ.update(TM_CUDA_FIELD_IMPL="int64", TM_CUDA_BASE_MXU="0")
    emit("layout-main-path", card=card, validators=10_000, auto_resolved_to=auto_impl,
         kernels={f"{impl}/{mxu}": kernel_for(impl, mxu) for impl, mxu in settings},
         e2e_p50_ms={k: {name: p50(t) for name, t in v.items()} for k, v in layout_times.items()},
         kernel_p50_ms={name: timing[(name, 10_000)]["ms"]
                        for name in kernels.VERIFY_KERNELS.values()},
         runs=LAYOUT_RUNS)
    path_kernels = (*kernels.VERIFY_KERNELS.values(), "ed25519_rlc", "rlc_fold")
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
               "ed25519_rlc": "ed25519_rlc.cu", "rlc_fold": "ed25519_rlc.cu"}
    replaces = {"ed25519_verify": "tendermint_tpu/ops/ed25519_jax.py:529",
                "ed25519_verify_comb": "tendermint_tpu/ops/ed25519_jax.py:328",
                "ed25519_verify_packed": "tendermint_tpu/ops/ed25519_jax.py:529",
                "ed25519_verify_f32": "tendermint_tpu/ops/ed25519_jax.py:529",
                "ed25519_verify_f32_comb": "tendermint_tpu/ops/ed25519_jax.py:328",
                "fe_ops": "tendermint_tpu/ops/fe25519.py:108",
                "fe_ops_packed": "tendermint_tpu/ops/fe25519_packed.py:167",
                "fe_ops_f32": "tendermint_tpu/ops/fe25519_f32.py:221",
                "decompress": "tendermint_tpu/ops/ed25519_jax.py:217",
                "comb_select": "tendermint_tpu/ops/ed25519_jax.py:328",
                "ed25519_rlc": "tendermint_tpu/ops/ed25519_jax.py:422",
                "rlc_fold": "tendermint_tpu/ops/ed25519_jax.py:390"}
    table_line = [{"name": name, "route": "cuda", "source": csrc + sources[name],
                   "replaces": replaces[name], "launches": main_launches[name],
                   **{k: v for k, v in timing[(name, 10_000)].items() if k != "lanes"},
                   "max_abs_err": errs[name]}
                  for name in replaces]
    print(card, flush=True)
    print(json.dumps({"kernels": table_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
