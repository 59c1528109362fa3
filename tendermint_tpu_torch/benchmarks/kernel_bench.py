"""Device-kernel microbenchmark: the raw verify kernel of each field layout
(int64, packed, f32, f32 with the tensor-core multiply, and the comb) on
one batch, timed on the card.  Counterpart of the JAX package's
``benchmarks/kernel_bench.py``.

The kernel is launched through ``ops/kernels.verify(impl, base_mxu,
fe_mxu)`` with no golden gate, as the original skips it: ``verify_ok``
reports a wrong kernel instead of hiding it behind the ladder's fallback.
Device time comes from CUDA events around each launch alone (the card
first spins for a while, so every launch is queued before it runs and
the host's launch overhead is not timed); the original's wall clock
included a host copy of the verdicts, which does not exist here.
``compile_s`` is the kernel library's build and load, 0 once it is
loaded in the process.

Usage:
    python -m tendermint_tpu_torch.benchmarks.kernel_bench [--impl int64|packed|f32]
        [--mxu] [--batch 16384] [--reps 5] [--device cuda|cpu]
    (--mxu, f32's tensor-core multiply, is also set by TM_CUDA_FE_MXU=1; the
    comb by TM_CUDA_BASE_MXU=1)
    python -m tendermint_tpu_torch.benchmarks.kernel_bench --all [--batch N]

Prints one JSON line per run:
  {"impl": ..., "batch": N, "platform": "gpu", "device": <card>,
   "device_ms": p50, "device_ms_min": ..., "us_per_sig": ...,
   "host_prep_ms": ..., "compile_s": ..., "verify_ok": true}

On ``--device cpu`` the plain PyTorch version runs instead of the kernel;
its time is ``plain_ms`` and the device times are null.  Without a CUDA
device and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import statistics
import time

from .. import knobs, testkit
from ..ops import ed25519_torch, kernels
from .card import build_seconds, device_times_ms, host_times_ms, platform, resolve


@functools.cache
def _signed(n: int, seed: int):
    keys = testkit.validator_keys(seed, min(64, n))
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        k = keys[i % len(keys)]
        m = hashlib.sha256(i.to_bytes(4, "little")).digest()
        pubs.append(k.pub_key().bytes_())
        msgs.append(m)
        sigs.append(k.sign(m))
    return pubs, msgs, sigs


def gen_batch(n: int, bad_every: int = 97, seed: int = 0):
    """n signatures by 64 keys made from `seed`, message i = SHA-256 of i;
    row i is corrupted (its last byte flipped) where i % bad_every == 7
    (the original's recipe; 0 corrupts nothing).  Returns (pubs, msgs,
    sigs, want).  The signing is done once per (n, seed) in a process."""
    pubs, msgs, sigs = _signed(n, seed)
    sigs, want = list(sigs), [True] * n
    for i in range(n):
        if bad_every and i % bad_every == 7:
            sigs[i] = sigs[i][:-1] + bytes([sigs[i][-1] ^ 1])
            want[i] = False
    return list(pubs), list(msgs), sigs, want


def impl_label(impl: str, base_mxu: bool, fe_mxu: bool) -> str:
    return impl + ("+fe_mxu" if fe_mxu else "") + ("+base_mxu" if base_mxu else "")


def run_bench(impl: str = "int64", batch: int = 16384, reps: int = 5,
              device: str | None = None, base_mxu: bool = False, fe_mxu: bool = False) -> dict:
    """Time the verify kernel of (impl, base_mxu, fe_mxu) on `batch` rows
    of ``gen_batch``; check its verdicts."""
    dev = resolve(device)
    pubs, msgs, sigs, want = gen_batch(batch)
    t0 = time.perf_counter()
    rows_np = ed25519_torch.prepare_batch(pubs, msgs, sigs)
    host_prep_ms = (time.perf_counter() - t0) * 1e3
    rows = ed25519_torch.rows_to_device(rows_np, dev)
    res = {"impl": impl_label(impl, base_mxu, fe_mxu), "batch": batch, **platform(dev)}
    if dev.type == "cuda":
        compile_s = build_seconds()
        table = ed25519_torch.kernel_table(impl, base_mxu, dev)
        launch = kernels.verify(impl, base_mxu, fe_mxu)
        out = launch(*rows, table)
        times = device_times_ms(lambda: launch(*rows, table), reps)
        ms = statistics.median(times)
        res.update(device_ms=ms, device_ms_min=min(times), us_per_sig=ms * 1e3 / batch)
    else:
        compile_s = 0.0
        out, times = host_times_ms(lambda: ed25519_torch.verify_core(
            *rows, impl=impl, base_mxu=base_mxu, fe_mxu=fe_mxu), reps)
        res.update(device_ms=None, device_ms_min=None, us_per_sig=None,
                   plain_ms=statistics.median(times))
    res.update(host_prep_ms=host_prep_ms, compile_s=compile_s,
               verify_ok=out.cpu().tolist() == want)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="int64", choices=list(ed25519_torch.IMPLS))
    ap.add_argument("--mxu", action="store_true",
                    help="f32's tensor-core multiply (also TM_CUDA_FE_MXU=1)")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--all", action="store_true", help="every verify kernel, in one process")
    args = ap.parse_args(argv)
    base_mxu = knobs.read("TM_CUDA_BASE_MXU") == "1"
    fe_mxu = args.mxu or knobs.read("TM_CUDA_FE_MXU") == "1"
    settings = sorted(kernels.VERIFY_KERNELS) if args.all else [(args.impl, base_mxu, fe_mxu)]
    for impl, base_mxu, fe_mxu in settings:
        print(json.dumps(run_bench(impl, args.batch, args.reps, args.device, base_mxu, fe_mxu)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
