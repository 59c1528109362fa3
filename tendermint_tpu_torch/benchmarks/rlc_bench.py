"""Device benchmark of the RLC batch-verification path: the RLC kernel of a
field layout and, above 128 lanes, its fold (``ops/kernels.rlc(impl,
fe_mxu)`` + ``rlc_fold``), against the per-row verify kernel of the same
layout on the same all-valid batch.  Counterpart of the JAX package's
``benchmarks/rlc_bench.py``.

Device times come from CUDA events around the launches alone (the
original's wall clock included a host copy of every output, which does
not exist here).  ``rlc_ok``: the raw kernel's prevalid rows are all
true, and ``verify_batch_rlc`` (the entry point, with the host's big-int
finish) accepts the batch without its per-row fallback.
``mixed_verdicts_exact``: a 64-row batch with every 13th row bad gets the
per-row verdicts through ``verify_batch_rlc``.  ``compile_rlc_s`` is the
kernel library's build and load, 0 once it is loaded; ``compile_row_s``
is then 0 too (one library holds both kernels).

Usage:
    python -m tendermint_tpu_torch.benchmarks.rlc_bench [--impl int64|packed|f32]
        [--mxu] [--batch 16384] [--reps 5] [--device cuda|cpu]

Prints one JSON line:
  {"impl": ..., "batch": N, "platform": "gpu", "device": <card>,
   "rlc_device_ms": p50, "rlc_device_ms_min": ..., "row_device_ms": p50,
   "speedup": ..., "us_per_sig_rlc": ..., "host_scalars_ms": ...,
   "compile_rlc_s": ..., "compile_row_s": ..., "rlc_ok": true,
   "mixed_verdicts_exact": true}

On ``--device cpu`` the plain versions run; their times are
``rlc_plain_ms`` and ``row_plain_ms`` and the device times are null.
Without a CUDA device and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from .. import knobs
from ..ops import ed25519_torch, kernels
from .card import build_seconds, device_times_ms, host_times_ms, platform, resolve
from .kernel_bench import gen_batch, impl_label


def run_rlc_bench(impl: str = "int64", batch: int = 16384, reps: int = 5,
                  device: str | None = None, fe_mxu: bool = False) -> dict:
    dev = resolve(device)
    pubs, msgs, sigs, _ = gen_batch(batch, bad_every=0)  # the honest consensus path
    rows_np = ed25519_torch.prepare_batch(pubs, msgs, sigs)
    pub, r, s, k, valid = rows_np
    t0 = time.perf_counter()
    z, zk, c_row = ed25519_torch.prepare_rlc_scalars(s, k, valid)
    host_scalars_ms = (time.perf_counter() - t0) * 1e3
    rlc_in = ed25519_torch.rows_to_device((pub, r, zk, z, valid), dev)
    row_in = ed25519_torch.rows_to_device(rows_np, dev)
    res = {"impl": impl_label(impl, False, fe_mxu), "batch": batch, **platform(dev)}
    if dev.type == "cuda":
        compile_rlc_s = build_seconds()
        table = ed25519_torch.kernel_table(impl, False, dev)
        rlc, row = kernels.rlc(impl, fe_mxu), kernels.verify(impl, False, fe_mxu)

        def rlc_fn():
            lanes, prevalid = rlc(*rlc_in)
            if lanes.shape[0] > kernels.RLC_MAX_LANES:
                lanes = kernels.rlc_fold(lanes)
            return lanes, prevalid

        prevalid = rlc_fn()[1]
        row(*row_in, table)
        rlc_ts = device_times_ms(rlc_fn, reps)
        row_ts = device_times_ms(lambda: row(*row_in, table), reps)
        rlc_ms, row_ms = statistics.median(rlc_ts), statistics.median(row_ts)
        res.update(rlc_device_ms=rlc_ms, rlc_device_ms_min=min(rlc_ts), row_device_ms=row_ms,
                   speedup=row_ms / rlc_ms, us_per_sig_rlc=rlc_ms * 1e3 / batch)
    else:
        compile_rlc_s = 0.0
        (_, prevalid), rlc_ts = host_times_ms(lambda: ed25519_torch.verify_core_rlc(
            *rlc_in, impl=impl, fe_mxu=fe_mxu), reps)
        _, row_ts = host_times_ms(lambda: ed25519_torch.verify_core(
            *row_in, impl=impl, fe_mxu=fe_mxu), reps)
        res.update(rlc_device_ms=None, rlc_device_ms_min=None, row_device_ms=None,
                   speedup=None, us_per_sig_rlc=None, rlc_plain_ms=statistics.median(rlc_ts),
                   row_plain_ms=statistics.median(row_ts))
    fallbacks = ed25519_torch.RLC_STATS["fallback"]
    e2e = ed25519_torch.verify_batch_rlc(pubs, msgs, sigs, impl=impl, device=dev)
    rlc_ok = (bool(prevalid.all()) and bool(e2e.all())
              and ed25519_torch.RLC_STATS["fallback"] == fallbacks)
    mpubs, mmsgs, msigs, mwant = gen_batch(64, bad_every=13)
    mixed = ed25519_torch.verify_batch_rlc(mpubs, mmsgs, msigs, impl=impl, device=dev)
    res.update(host_scalars_ms=host_scalars_ms, compile_rlc_s=compile_rlc_s, compile_row_s=0.0,
               rlc_ok=rlc_ok, mixed_verdicts_exact=mixed.tolist() == mwant)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="int64", choices=list(ed25519_torch.IMPLS))
    ap.add_argument("--mxu", action="store_true",
                    help="f32's tensor-core multiply (also TM_CUDA_FE_MXU=1)")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    fe_mxu = args.mxu or knobs.read("TM_CUDA_FE_MXU") == "1"
    print(json.dumps(run_rlc_bench(args.impl, args.batch, args.reps, args.device, fe_mxu)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
