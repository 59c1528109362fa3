"""Roofline probes of the card: is a verify kernel at the floor of the pipe
it runs on, or far from it?  Counterpart of the JAX package's
``benchmarks/roofline_probe.py``, in four parts:

1. ``--census``: the pipe instructions one signature costs in each verify
   kernel, from the counts the kernels' bounds are priced with
   (``ops/kernels.FIELD_OPS_PER_ROW`` and ``operations``, which the host
   builds count in the kernels' own code).  No new counting.

2. ``--chain KIND``: saturating chains of one operation, one thread per
   element, kernel ``op_chain`` (``csrc/probes.cu``): floor (a chain of
   2 at 8 x 128: the launch floor), i32mul, i64mul, i64add (x = (x op y)
   & mask) and f32mul (x = x * y); and the field multiplies: femul8 (the
   32 x 8-bit multiply, row-major [N, 32], kernel ``pl_femul8``) and
   femul51 (the port's production 5 x 51-bit int64 fe_mul, kernel
   ``fe_mul_chain``; the original's femul17 chained the JAX package's
   15 x 17-bit one).

3. ``--pallas`` / ``--pallas-kind``: the two Pallas probes as CUDA kernels,
   ``pl_i32mul`` (int32 [rows, 128], x = (x * y) & 255) and ``pl_femul8``
   (the 32 x 8-bit multiply, limb-major [32, N], coalesced across lanes).

4. ``roofline`` (with ``--all``): the instruction rate achieved inside
   ``ed25519_verify``, ``ed25519_verify_packed`` and ``ed25519_verify_f32``
   at 10,000 rows (census over kernel time) against the rate the chains
   sustain on the same pipe, and the data sheet's.

Every probe runs at its original shape and at one that fills every SM for
several waves (``SATURATING_THREADS``): a probe of under one wave
measures a thread's latency, not a pipe's rate.  On the card each probe's
first launch is held against its plain PyTorch version on the same
inputs (integers and f32 exactly: a chain of single IEEE multiplies has
one answer), and a difference raises.  Time comes from CUDA events around
each launch alone; the original's wall clock included a host copy over a
tunnel (its comment on the shapes), which does not exist here.  Each line
adds ``bound_ms`` (the larger of the bytes over 3.35 TB/s and, per pipe,
the instructions of one chain step times the steps over the pipe's rate
on every SM at the top clock), ``pipe`` (the one that bounds it, or
"bytes") and ``pipe_share`` (bound over measured time).  The
instructions of a step are read from the SASS of the probe kernel's loop
(cuobjdump on the built library): ``step_instructions`` per pipe and the
loop's raw opcode counts, ``sass_loop``; ``sustained_per_s`` is each
pipe's rate over the measured time.  femul51's step is the verify
kernels' multiply, and its bound is priced as theirs is (100 IMAD,
``ops/kernels.LAYOUT_PRODUCTS``), so that one function has one bound;
``sass_bound_ms``, ``sass_pipe`` and ``sass_pipe_share`` price every
probe from its SASS.

Usage:
    python -m tendermint_tpu_torch.benchmarks.roofline_probe --census
    python -m tendermint_tpu_torch.benchmarks.roofline_probe --chain i64mul
    python -m tendermint_tpu_torch.benchmarks.roofline_probe --pallas
    python -m tendermint_tpu_torch.benchmarks.roofline_probe --all [--out FILE]

Each probe prints one JSON line (and appends it to ``--out``).  On
``--device cpu`` the plain versions run, by request: their times are
host times, ``platform`` says "cpu" and the device numbers are null.
Without a CUDA device and without ``--device cpu`` it raises, as does a
failed build or launch.  ``--all`` runs every probe in one process.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
from collections import Counter

import numpy as np
import torch

from ..crypto import ed25519 as _ref
from ..ops import kernels
from .card import build_seconds, device_times_ms, host_times_ms, pipe_rates, platform, resolve
from .kernel_bench import run_bench

THREADS_PER_SM = 2048
# a probe of fewer threads than four waves of full occupancy on 132 SMs
# runs again at eight waves
SATURATING_MIN_THREADS = 132 * THREADS_PER_SM * 4
SATURATING_THREADS = 132 * THREADS_PER_SM * 8

NL8, BITS8, MASK8 = kernels.FEMUL8_LIMBS, 8, 255
MASK51 = (1 << 51) - 1
AGREE_LANES = 8  # lanes of a field-multiply probe checked against big-int

# (kind, rows, lanes, chain): the JAX tool's shapes; femul51 takes femul17's
ALL_CHAINS = [
    ("floor", 8, 128, 2),
    ("i64mul", 65536, 128, 512),
    ("i64mul", 559240, 15, 512),
    ("i32mul", 65536, 128, 512),
    ("f32mul", 65536, 128, 512),
    ("i64add", 65536, 128, 512),
    ("femul51", 65536, 5, 256),
    ("femul8", 32768, 32, 128),
]
ALL_PALLAS = [
    ("pl_i32mul", 16384, 64),
    ("pl_femul8", 16384, 8),
]
CHAIN_KINDS = ("floor", "i64mul", "i64add", "i32mul", "f32mul", "femul51", "femul8")
PALLAS_KINDS = ("pl_i32mul", "pl_femul8")
OP_CHAIN_UNROLL = 16  # csrc/probes.cu: op_chain's steps per loop iteration
# probe kind -> (the kernel it launches, a count in ops/kernels.LAUNCHES;
# that kernel's SASS function; chain steps per loop iteration there)
PROBE_KINDS = {"pl_i32mul": ("pl_i32mul", "op_chain_i32mul", OP_CHAIN_UNROLL),
               **{kind: ("op_chain", f"op_chain_{'i32mul' if kind == 'floor' else kind}",
                         OP_CHAIN_UNROLL) for kind in kernels.OP_CHAIN_KINDS},
               "pl_femul8": ("pl_femul8", "pl_femul8_limb_major", 1),
               "femul8": ("pl_femul8", "pl_femul8_row_major", 1),
               "femul51": ("fe_mul_chain", "fe_mul_chain", 1)}
# probe kind -> the instructions per pipe of one chain step its bound
# prices, where that is not its SASS: femul51 is the verify kernels' 5 x
# 51-bit multiply, which their bounds price at 100 IMAD
_PER_MUL51, _, _PIPE51 = kernels.LAYOUT_PRODUCTS["51"]
PRICED_STEPS = {"femul51": {_PIPE51: _PER_MUL51}}
# the verify kernels the roofline line reads, by field layout
ROOFLINE_KERNELS = {"int64": "ed25519_verify", "packed": "ed25519_verify_packed",
                    "f32": "ed25519_verify_f32"}
ROOFLINE_ROWS = 10_000


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic in PyTorch, any device)
# ---------------------------------------------------------------------------

def op_chain_plain(kind: str, x: torch.Tensor, y: torch.Tensor, chain: int) -> torch.Tensor:
    """`chain` steps of `kind`'s operation (``kernels.OP_CHAIN_KINDS``);
    pl_i32mul is the kind i32mul."""
    mask = kernels.OP_CHAIN_KINDS[kind][1]
    for _ in range(chain):
        if kind == "i64add":
            x = (x + y) & mask
        elif kind == "f32mul":
            x = x * y
        else:
            x = (x * y) & mask
    return x


def fe_mul8_plain(a: torch.Tensor, b: torch.Tensor, limb_dim: int = -1) -> torch.Tensor:
    """The 32 x 8-bit multiply on int32 limbs along `limb_dim` (0: the
    limb-major [32, N] of ``pl_femul8``, -1: row-major [N, 32]): 63
    schoolbook columns, the high 31 folded down x38 (2^256 = 38 mod p),
    then 6 carry rounds.  The JAX functions' limbs exactly; limbs < 2^10
    keep every column < 2^30.3."""
    a, b = a.movedim(limb_dim, -1), b.movedim(limb_dim, -1)
    cols = torch.zeros(a.shape[:-1] + (2 * NL8 - 1,), dtype=torch.int32, device=a.device)
    for i in range(NL8):
        cols[..., i:i + NL8] += a[..., i:i + 1] * b
    c = cols[..., :NL8].clone()
    c[..., :NL8 - 1] += 38 * cols[..., NL8:]
    for _ in range(6):
        h = c >> BITS8
        c = (c & MASK8) + torch.cat([38 * h[..., -1:], h[..., :-1]], dim=-1)
    return c.movedim(-1, limb_dim).contiguous()


# limb pair (i, j) of fe_mul lands in column (i + j) mod 5, times 19 past 2^255
_FOLD19 = np.array([[19 if i + j >= 5 else 1 for j in range(5)] for i in range(5)])
_COL5 = np.array([(i + j) % 5 for i in range(5) for j in range(5)])


def fe_mul51_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' 5 x 51-bit fe_mul (``csrc/ed25519_common.cuh``) limb
    for limb, on int64 [..., 5] with limbs < 2^52.  Its 128-bit columns
    are held as int64 pieces: each product a_i * b'_j (b' = b or 19 b) is
    split at bit 27 of both operands into three partial sums, which are
    then cut into the column's low 51 bits and the rest, and carried as
    the kernel carries."""
    m27 = (1 << 27) - 1
    fold = torch.as_tensor(_FOLD19, device=a.device)
    col = torch.as_tensor(_COL5, device=a.device)
    bp = b[..., None, :] * fold  # [..., i, j]: b_j, or 19 b_j, < 2^56.3
    a_lo, a_hi = (a & m27)[..., :, None], (a >> 27)[..., :, None]
    b_lo, b_hi = bp & m27, bp >> 27

    def columns(prod):
        out = torch.zeros_like(a)
        return out.index_add_(-1, col, prod.reshape(prod.shape[:-2] + (25,)))

    p0, p2 = columns(a_lo * b_lo), columns(a_hi * b_hi)
    p1 = columns(a_lo * b_hi + a_hi * b_lo)
    # column = p0 + p1 2^27 + p2 2^54 = lo + hi 2^51, lo < 2^51
    t = p0 + ((p1 & ((1 << 24) - 1)) << 27)
    lo, hi = t & MASK51, (t >> 51) + (p1 >> 24) + (p2 << 3)
    r = [lo[..., 0]]
    carry = hi[..., 0]
    for k in range(1, 5):
        t = lo[..., k] + carry
        r.append(t & MASK51)
        carry = hi[..., k] + (t >> 51)
    r[0] = r[0] + carry * 19
    r[1] = r[1] + (r[0] >> 51)
    r[0] = r[0] & MASK51
    return torch.stack(r, dim=-1)


def femul8_chain_plain(x, y, chain: int, limb_major: bool) -> torch.Tensor:
    for _ in range(chain):
        x = fe_mul8_plain(x, y, 0 if limb_major else -1)
    return x


def fe_mul51_chain_plain(x, y, chain: int) -> torch.Tensor:
    for _ in range(chain):
        x = fe_mul51_plain(x, y)
    return x


def int_from_limbs(limbs, bits: int) -> int:
    return sum(int(v) << (bits * i) for i, v in enumerate(limbs))


# ---------------------------------------------------------------------------
# The SASS of a probe's loop
# ---------------------------------------------------------------------------

def library_sass() -> str:
    """cuobjdump's SASS of the built kernel library, kept beside it
    (``<library>.sass``) once disassembled."""
    lib = kernels.build()
    path = lib.with_suffix(".sass")
    if not path.exists():
        from torch.utils.cpp_extension import CUDA_HOME

        part = lib.with_suffix(".sass.part")
        with open(part, "w") as f:
            subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)], stdout=f,
                           check=True, timeout=600)
        part.replace(path)
    return path.read_text()


_INSN = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_\w+):")


@functools.lru_cache(maxsize=2)
def sass_functions(sass: str) -> dict[str, list[str]]:
    """cuobjdump's SASS cut into each function's lines, by name."""
    out, lines = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            lines = out.setdefault(line.split("Function : ")[1].strip(), [])
        elif lines is not None:
            lines.append(line)
    return out


def sass_loop(sass: str, function: str) -> Counter:
    """Opcode counts of the largest loop of `function` in cuobjdump's
    SASS: the instructions from a backward branch's target up to the
    branch."""
    body, labels = [], {}
    for line in sass_functions(sass).get(function, ()):
        if (m := _LABEL.match(line)):
            labels[m.group(1)] = None  # the address of the next instruction
            continue
        if (m := _INSN.match(line)):
            addr, words = int(m.group(1), 16), m.group(2).split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            for name, at in labels.items():
                if at is None:
                    labels[name] = addr
            body.append((addr, words[0], words[1:]))
    if not body:
        raise RuntimeError(f"no SASS for {function}")
    loops = []
    for addr, op, args in body:
        if op.startswith("BRA") and args:
            target = args[-1].strip("`()")
            try:
                to = labels[target] if target in labels else int(target, 16)
            except ValueError:
                continue
            if to is not None and to <= addr:
                loops.append((addr - to, to, addr))
    if not loops:
        raise RuntimeError(f"no loop in the SASS of {function}")
    _, start, end = max(loops)
    return Counter(op for addr, op, _ in body if start <= addr <= end)


def pipe_of(opcode: str) -> str | None:
    """The pipe an instruction issues to, as the bounds price them; None
    for memory, branch, uniform-datapath and control instructions."""
    base = opcode.split(".")[0]
    if base in ("IMAD", "IMUL", "IDP"):
        return "imad"
    if base in ("FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2"):
        return "ffma"
    if (base.startswith(("LD", "ST", "RED", "ATOM", "BRA", "BRX", "JMP", "BAR", "S2", "CS2R",
                         "U"))
            or base in ("EXIT", "NOP", "BSSY", "BSYNC", "BREAK", "BPT", "WARPSYNC", "CALL",
                        "RET", "YIELD", "DEPBAR", "MEMBAR", "ERRBAR")):
        return None
    return "alu"


def bounds_ms(per_step: dict[str, float], steps: int, nbytes: int,
              rates: dict[str, float]) -> dict[str, float]:
    """ms of `steps` chain steps of `per_step` instructions on each pipe at
    `rates`, and of `nbytes` at the device memory rate ("bytes")."""
    out = {pipe: count * steps / rates[pipe] * 1e3 for pipe, count in per_step.items()}
    out["bytes"] = nbytes / kernels.HBM_BYTES_PER_S * 1e3
    return out


def step_instructions(loop: Counter, steps: int) -> dict[str, float]:
    """Instructions per chain step on each pipe, the loop's counter and
    branch included."""
    per_pipe = Counter()
    for op, count in loop.items():
        if (pipe := pipe_of(op)) is not None:
            per_pipe[pipe] += count
    return {pipe: count / steps for pipe, count in sorted(per_pipe.items())}


# ---------------------------------------------------------------------------
# The probes
# ---------------------------------------------------------------------------

def chain_inputs(kind: str, rows: int, lanes: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's inputs of `run_chain` (seed 11); femul51's limbs
    are random 51-bit values."""
    rng = np.random.default_rng(11)
    if kind in ("floor", "i32mul"):
        return (rng.integers(1, 256, (rows, lanes)).astype(np.int32),
                rng.integers(1, 256, (rows, lanes)).astype(np.int32))
    if kind in ("i64mul", "i64add"):
        return (rng.integers(1, 1 << 17, (rows, lanes)).astype(np.int64),
                rng.integers(1, 1 << 17, (rows, lanes)).astype(np.int64))
    if kind == "f32mul":
        return (rng.uniform(0.5, 2.0, (rows, lanes)).astype(np.float32),
                rng.uniform(0.99999, 1.00001, (rows, lanes)).astype(np.float32))
    if kind == "femul51":
        if lanes != 5:
            raise ValueError("femul51 takes 5 lanes (limbs)")
        return (rng.integers(0, 1 << 51, (rows, 5), dtype=np.int64),
                rng.integers(0, 1 << 51, (rows, 5), dtype=np.int64))
    if kind == "femul8":
        if lanes != NL8:
            raise ValueError(f"femul8 takes {NL8} lanes (limbs)")
        return (rng.integers(0, 256, (rows, NL8)).astype(np.int32),
                rng.integers(0, 256, (rows, NL8)).astype(np.int32))
    raise ValueError(kind)


def pallas_inputs(kind: str, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's inputs of `run_pallas` (seed 3)."""
    rng = np.random.default_rng(3)
    if kind == "pl_i32mul":
        return (rng.integers(1, 256, (rows, 128)).astype(np.int32),
                rng.integers(1, 256, (rows, 128)).astype(np.int32))
    if kind == "pl_femul8":
        return (rng.integers(0, 256, (NL8, rows)).astype(np.int32),
                rng.integers(0, 256, (NL8, rows)).astype(np.int32))
    raise ValueError(kind)


def launchers(kind: str):
    """(kernel launch, plain version) of probe `kind`, each f(x, y, chain)."""
    if kind == "pl_i32mul":
        return kernels.pl_i32mul, functools.partial(op_chain_plain, "i32mul")
    if kind in kernels.OP_CHAIN_KINDS:
        return (functools.partial(kernels.op_chain, kind),
                functools.partial(op_chain_plain, kind))
    if kind in ("femul8", "pl_femul8"):
        limb_major = kind == "pl_femul8"
        return (functools.partial(kernels.pl_femul8, limb_major=limb_major),
                functools.partial(femul8_chain_plain, limb_major=limb_major))
    if kind == "femul51":
        return kernels.fe_mul_chain, fe_mul51_chain_plain
    raise ValueError(kind)


def threads_of(kind: str, shape: tuple) -> int:
    """Threads (elements of a chain) of probe `kind` on inputs of `shape`."""
    if kind == "pl_femul8":
        return shape[1]
    if kind in ("femul8", "femul51"):
        return shape[0]
    return shape[0] * shape[1]


def saturating_shape(kind: str, rows: int, lanes: int) -> tuple[int, int]:
    """(rows, lanes) of `kind` that fill every SM for several waves: the
    given shape if it has ``SATURATING_MIN_THREADS`` threads, else one of
    ``SATURATING_THREADS``."""
    shape = (lanes, rows) if kind == "pl_femul8" else (rows, lanes)
    if threads_of(kind, shape) >= SATURATING_MIN_THREADS:
        return rows, lanes
    if kind in ("femul8", "femul51", "pl_femul8"):
        return SATURATING_THREADS, lanes
    return SATURATING_THREADS // lanes, lanes


def _probe(probe: str, kind: str, x_np, y_np, chain: int, reps: int, dev: torch.device,
           sass: str | None) -> dict:
    """Run probe `kind` on x, y; returns its JSON fields after the
    original's ``chain``."""
    launch, plain = launchers(kind)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    threads = threads_of(kind, x_np.shape)
    res = {}
    if dev.type == "cuda":
        compile_s = build_seconds()
        out = launch(x, y, chain)
        want, plain_times = host_times_ms(lambda: plain(x, y, chain), 1)
        err = (out - want).abs().max().item() if out.numel() else 0
        if err != 0:
            raise RuntimeError(f"{probe} {kind}: the kernel differs from its plain version "
                               f"(max abs err {err})")
        times = device_times_ms(lambda: launch(x, y, chain), reps)
        ms = statistics.median(times)
        _, function, steps = PROBE_KINDS[kind]
        loop = sass_loop(library_sass() if sass is None else sass, function)
        per_step = step_instructions(loop, steps)
        rates = pipe_rates(dev)
        bounds, sass_bounds = (bounds_ms(priced, threads * chain, 3 * x.nbytes, rates)
                               for priced in (PRICED_STEPS.get(kind, per_step), per_step))
        pipe, sass_pipe = max(bounds, key=bounds.get), max(sass_bounds, key=sass_bounds.get)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res.update(ms=ms, ms_min=min(times), compile_s=compile_s, plain_ms=plain_times[0],
                   max_abs_err=err, waves=threads / (sms * THREADS_PER_SM),
                   bound_ms=bounds[pipe], pipe=pipe, pipe_share=bounds[pipe] / ms,
                   sass_bound_ms=sass_bounds[sass_pipe], sass_pipe=sass_pipe,
                   sass_pipe_share=sass_bounds[sass_pipe] / ms, step_instructions=per_step,
                   sustained_per_s={pipe: count * threads * chain / (ms * 1e-3)
                                    for pipe, count in per_step.items()},
                   sass_loop=dict(sorted(loop.items())), steps_per_loop=steps)
    else:
        out, times = host_times_ms(lambda: plain(x, y, chain), reps)
        ms = statistics.median(times)
        res.update(ms=ms, ms_min=min(times), compile_s=0.0, bound_ms=None, pipe=None,
                   pipe_share=None)
    out = out.cpu().numpy()
    if kind in ("femul8", "pl_femul8", "femul51"):
        # lane 0 and a sample of others against big-int arithmetic mod p
        bits = 51 if kind == "femul51" else BITS8
        lane = (lambda a, i: a[:, i]) if kind == "pl_femul8" else (lambda a, i: a[i])
        res["agree"] = all(
            int_from_limbs(lane(out, i), bits) % _ref.P
            == int_from_limbs(lane(x_np, i), bits)
            * pow(int_from_limbs(lane(y_np, i), bits), chain, _ref.P) % _ref.P
            for i in np.unique(np.linspace(0, threads - 1, AGREE_LANES).astype(int)))
        res["ns_per_femul_elem"] = ms * 1e6 / (chain * threads)
    else:
        ops_per_iter = 1 if kind == "f32mul" else 2
        if probe == "chain":
            res["g_lane_iters_per_s"] = threads * chain / (ms * 1e-3) / 1e9
        res["g_ops_per_s"] = threads * chain * ops_per_iter / (ms * 1e-3) / 1e9
    return res


def run_chain(kind: str, rows: int, lanes: int, chain: int, reps: int = 5,
              device: str | None = None, sass: str | None = None) -> dict:
    """One chain probe (``CHAIN_KINDS``) at [rows, lanes]."""
    dev = resolve(device)
    if kind not in CHAIN_KINDS:
        raise ValueError(f"no chain kind {kind!r}")
    x, y = chain_inputs(kind, rows, lanes)
    return {"probe": "chain", "kind": kind, **platform(dev), "rows": rows, "lanes": lanes,
            "chain": chain, **_probe("chain", kind, x, y, chain, reps, dev, sass)}


def run_pallas(kind: str, rows: int, chain: int, reps: int = 5, device: str | None = None,
               sass: str | None = None) -> dict:
    """One of the two Pallas probes (``PALLAS_KINDS``) on `rows` rows
    (pl_i32mul) or lanes (pl_femul8)."""
    dev = resolve(device)
    x, y = pallas_inputs(kind, rows)
    return {"probe": "pallas", "kind": kind, **platform(dev), "rows": rows,
            "lanes": 128 if kind == "pl_i32mul" else NL8, "chain": chain,
            **_probe("pallas", kind, x, y, chain, reps, dev, sass)}


def run_census() -> list[dict]:
    """Per verify kernel: the pipe instructions of one signature, as its
    bound prices them."""
    lines = []
    for (impl, base_mxu, fe_mxu), name in kernels.VERIFY_KERNELS.items():
        muls, sqs = kernels.field_ops(name, 1)
        ops = kernels.operations(name, 1)
        mul_ops = (ops["int8_mma"] if name in kernels.MMA_KERNELS
                   else kernels.LAYOUT_PRODUCTS[kernels.layout(name)][0] * muls)
        lines.append({
            "probe": "census", "impl": impl + ("+fe_mxu" if fe_mxu else "")
            + ("+base_mxu" if base_mxu else ""), "kernel": name,
            "lane_ops_per_sig": ops, "lane_mul_per_sig": mul_ops,
            "lane_ops_total_per_sig": sum(ops.values()),
            "calls": {"fe_mul": muls, "fe_sq": sqs},
            "note": ("limb products of the field multiplies and squarings, as instructions "
                     "of the pipe that bounds them (ops/kernels.operations): the "
                     "multiplies' share is lane_mul_per_sig; carries, selects and "
                     "decompression's byte work are not counted")})
    return lines


def run_roofline(results: list[dict], verify_ms: dict[str, float], dev: torch.device,
                 rows: int = ROOFLINE_ROWS) -> dict:
    """The instruction rate achieved inside each of ``ROOFLINE_KERNELS``
    (census over its kernel time at `rows` rows, `verify_ms` by kernel
    name) against the highest rate a probe in `results` sustained on the
    same pipe, and the data sheet's."""
    sustained = {}
    for res in results:
        for pipe, rate in (res.get("sustained_per_s") or {}).items():
            if rate > sustained.get(pipe, (0.0, ""))[0]:
                sustained[pipe] = (rate, f"{res['probe']} {res['kind']} "
                                         f"{res['rows']}x{res['lanes']} chain {res['chain']}")
    rates = pipe_rates(dev)
    out = {}
    for name in ROOFLINE_KERNELS.values():
        ((pipe, count),) = kernels.operations(name, rows).items()
        achieved = count / (verify_ms[name] * 1e-3)
        best, probe = sustained.get(pipe, (None, None))
        out[name] = {"pipe": pipe, "instructions": count, "kernel_ms": verify_ms[name],
                     "achieved_per_s": achieved, "sustained_per_s": best,
                     "sustained_by": probe, "datasheet_per_s": rates[pipe],
                     "achieved_over_sustained": achieved / best if best else None}
    return {"probe": "roofline", **platform(dev), "rows": rows, "kernels": out,
            "sustained_over_datasheet": {pipe: rate / rates[pipe]
                                         for pipe, (rate, _) in sustained.items()}}


def run_all(device: str | None = None, reps: int = 5, census: bool = True,
            sass: str | None = None, verify_ms: dict[str, float] | None = None):
    """Every probe in one process, as the lines it prints: the census, each
    chain and Pallas probe at its original and its saturating shape, and
    on the card the roofline line (timing the three verify kernels at
    10,000 rows unless `verify_ms` gives their times)."""
    dev = resolve(device)
    lines = run_census() if census else []
    probes = []
    for kind, rows, lanes, chain in ALL_CHAINS:
        for shape in dict.fromkeys(((rows, lanes), saturating_shape(kind, rows, lanes))):
            probes.append(run_chain(kind, *shape, chain, reps, device, sass))
    for kind, rows, chain in ALL_PALLAS:
        lanes = 128 if kind == "pl_i32mul" else NL8
        for n in dict.fromkeys((rows, saturating_shape(kind, rows, lanes)[0])):
            probes.append(run_pallas(kind, n, chain, reps, device, sass))
    lines += probes
    if dev.type == "cuda":
        if verify_ms is None:
            verify_ms = {name: run_bench(impl, ROOFLINE_ROWS, reps, device)["device_ms"]
                         for impl, name in ROOFLINE_KERNELS.items()}
        lines.append(run_roofline(probes, verify_ms, dev))
    return lines


def _emit(obj: dict, out_path: str | None) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out_path:
        with open(out_path, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--census", action="store_true")
    ap.add_argument("--chain", default=None, choices=CHAIN_KINDS)
    ap.add_argument("--pallas-kind", default=None, choices=PALLAS_KINDS)
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--chain-len", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-census", action="store_true")
    args = ap.parse_args(argv)
    resolve(args.device)  # without a card, only --device cpu runs
    if args.all:
        lines = run_all(args.device, args.reps, census=not args.skip_census)
    elif args.census:
        lines = run_census()
    elif args.chain:
        lines = [run_chain(args.chain, args.rows, args.lanes, args.chain_len, args.reps,
                           args.device)]
    elif args.pallas_kind:
        lines = [run_pallas(args.pallas_kind, args.rows, args.chain_len, args.reps,
                            args.device)]
    elif args.pallas:
        lines = [run_pallas(kind, rows, chain, args.reps, args.device)
                 for kind, rows, chain in ALL_PALLAS]
    else:
        ap.error("pick a mode: --census / --chain / --pallas / --all")
    for line in lines:
        _emit(line, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
