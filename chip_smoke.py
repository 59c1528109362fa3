#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of ``tendermint_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card, then
drives the port's commit-verification entry points at real validator-set
sizes: a 128-validator commit, a 10,000-validator commit (MaxVotesCount)
and a blocksync window of 50 commits x 200 validators.  Keys and
signatures are made from seeds.  Every phase prints one JSON line; any
mismatch or exception exits non-zero.  The last two lines are the
kernels' table and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py        # needs one CUDA device; no arguments

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 20261017
TIMED_RUNS = 12  # end-to-end runs per entry point; p50 over these
KERNEL_RUNS = 20  # launches per kernel timing, each with its own CUDA events; p50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
IMAD_PER_SM_PER_CLK = 64  # 32-bit integer multiply-add, compute capability 9.0


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1


    from tendermint_tpu_torch import testkit
    from tendermint_tpu_torch.crypto import ed25519 as ref
    from tendermint_tpu_torch.ops import ed25519_torch, fe25519, kernels
    from tendermint_tpu_torch.types.validator import CommitVerifyJob, batch_verify_commits

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    imad_per_s = sms * IMAD_PER_SM_PER_CLK * max_clock_mhz * 1e6

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
        ops_ms = n * kernels.imads_per_row(kernel) / imad_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    # -- 1. device and build ------------------------------------------------
    built_now = not kernels.library_path().exists()
    t0 = time.perf_counter()
    lib_path = kernels.build()
    build_s = time.perf_counter() - t0
    kernels.library()
    ptxas = [line.strip() for line in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0), sms=sms,
         max_sm_clock_mhz=max_clock_mhz, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, built_now=built_now, ptxas=ptxas)

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

    # -- 4. adversarial verify ----------------------------------------------
    cases = testkit.adversarial_cases(SEED)
    pubs, msgs, sigs = ([c[i] for c in cases] for i in range(3))
    rows = ed25519_torch.rows_to_device(ed25519_torch.prepare_batch(pubs, msgs, sigs), dev)
    kernel_v = ed25519_torch.verify_rows(*rows).cpu().tolist()
    plain_v = ed25519_torch.verify_core(*rows).cpu().tolist()
    ref_v = [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    adv_err = sum(k != p for k, p in zip(kernel_v, plain_v))
    check(kernel_v == plain_v == ref_v, "adversarial verdicts differ")
    check(any(ref_v) and not all(ref_v), "gauntlet lacks one outcome")
    emit("adversarial", rows=len(ref_v), accepted=sum(ref_v), max_abs_err=adv_err)

    # -- the main path: entry points only, counts reset before each call ----
    main_launches = dict.fromkeys(kernels.LAUNCHES, 0)

    def main_path(fn):
        """One entry-point call, which must launch ed25519_verify once."""
        kernels.reset_launches()
        try:
            fn()
        finally:
            counts = dict(kernels.LAUNCHES)
            for name, c in counts.items():
                main_launches[name] += c
            check(counts["ed25519_verify"] == 1,
                  f"expected one ed25519_verify launch, counted {counts}")

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
    # ed25519_verify gets the commit-10k rows with gauntlet rows, flipped
    # R bits and changed messages spread through them (both verdicts in
    # every 8 rows, so in every block of threads); its error is the count
    # of rows where kernel and plain version disagree.
    mpubs, mmsgs, msigs, mwant = testkit.mixed_batch(*triples, seed=SEED + 5)
    mixed_rows = ed25519_torch.rows_to_device(
        ed25519_torch.prepare_batch(mpubs, mmsgs, msigs), dev)
    table_bytes = table.numel() * table.element_size()
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
        shapes[n] = {
            "ed25519_verify": (
                lambda n=n: kernels.ed25519_verify(*(t[:n] for t in mixed_rows), table),
                lambda n=n: ed25519_torch.verify_core(*(t[:n] for t in mixed_rows)),
                n * (4 * 32 + 2) + table_bytes),
            "fe_ops": (lambda n=n: kernels.fe_ops(fe_rows[:n], fe_b[:n]),
                       lambda n=n: fe25519.fe_ops(fe_rows[:n], fe_b[:n]),
                       n * 5 * 32),
            "decompress": (lambda n=n: kernels.decompress(dec_rows[:n]),
                           lambda n=n: ed25519_torch.decompress_rows_plain(dec_rows[:n]),
                           n * (32 + 64 + 1)),
        }
    timing = {}
    errs = {"ed25519_verify": adv_err, "fe_ops": fe_err, "decompress": dec_err}
    for n, kernels_at_n in shapes.items():
        for name, (kernel_fn, plain_fn, nbytes) in kernels_at_n.items():
            got = kernel_fn()
            want, plain_ms = timed_host(plain_fn, 3)
            err = disagreement(got, want)
            check(err == 0, f"{name} differs from its plain version at N = {n}")
            errs[name] = max(errs[name], err)
            if name == "ed25519_verify":
                check(got.cpu().tolist() == mwant[:n], f"mixed verdicts at N = {n}")
                check(any(mwant[:n]) and not all(mwant[:n]), "mixed batch lacks one outcome")
            bound, bound_by = bound_ms(name, n, nbytes)
            timing[(name, n)] = {"ms": timed_kernel_ms(kernel_fn), "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err}
    emit("timing", card=card, imad_per_s=imad_per_s, kernel_runs=KERNEL_RUNS,
         mixed_rejected=mwant.count(False),
         kernels={f"{name}@{n}": t for (name, n), t in timing.items()})

    # -- the kernels' table and the result ----------------------------------
    source = "tendermint_tpu_torch/csrc/ed25519_verify.cu"
    replaces = {"ed25519_verify": "tendermint_tpu/ops/ed25519_jax.py:529",
                "fe_ops": "tendermint_tpu/ops/fe25519.py:108",
                "decompress": "tendermint_tpu/ops/ed25519_jax.py:217"}
    table_line = [{"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
                   "launches": main_launches[name],
                   **timing[(name, 10_000)], "max_abs_err": errs[name], "library_ms": None}
                  for name in ("ed25519_verify", "fe_ops", "decompress")]
    print(card, flush=True)
    print(json.dumps({"kernels": table_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
