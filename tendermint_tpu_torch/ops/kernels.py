"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links them into one shared library
with a plain C interface under ``_build/`` at first use (the file name
carries a hash of the sources and of the headers they include, so an
edited ``.cu`` or ``.cuh`` is rebuilt), and ``ctypes`` loads it.  Each
wrapper checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream without synchronising, raises if the entry point returns
a CUDA error, and adds one to its count in ``LAUNCHES``.  A wrapper takes
CUDA tensors only: the plain versions live beside the callers
(``ops/ed25519_torch.py``, ``ops/fe25519.py``), which pick one or the
other by the tensor's device.  Nothing here falls back to them.

Kernels: ``ed25519_verify``, its comb variant ``ed25519_verify_comb``,
``fe_ops``, ``decompress`` and ``comb_select`` (``csrc/ed25519_verify.cu``,
5 x 51-bit limbs); ``ed25519_verify_packed`` and ``fe_ops_packed``
(``csrc/ed25519_verify_packed.cu``, 10 x 25.5-bit limbs);
``ed25519_verify_f32``, ``ed25519_verify_f32_comb`` and ``fe_ops_f32``
(``csrc/ed25519_verify_f32.cu``, 51 x 5-bit float limbs);
``ed25519_verify_f32_mma``, ``ed25519_verify_f32_mma_comb`` and the part
kernel ``fe_mul_mma`` (``csrc/ed25519_verify_f32_mma.cu``, the f32 limbs
with fe_mul as an integer mma on the tensor cores, ``csrc/fe_f32_mma.cuh``);
the RLC kernels of every layout and their folds, ``ed25519_rlc``,
``ed25519_rlc_packed``, ``rlc_fold``, ``rlc_fold_packed``
(``csrc/ed25519_rlc.cu``) and ``ed25519_rlc_f32``, ``ed25519_rlc_f32_mma``,
``rlc_fold_f32`` (``csrc/ed25519_rlc_f32.cu``), all instances of
``csrc/ed25519_rlc.cuh``: an RLC kernel is three launches (points,
buckets, windows), each counted, on scratch its wrapper allocates.
Every source includes the curve pipeline of ``csrc/ed25519_common.cuh``;
the comb's selection, a gather, is ``csrc/base_comb.cuh``.  The device
probes ``pl_i32mul``, ``op_chain``, ``pl_femul8`` and ``fe_mul_chain``
(``csrc/probes.cu``) are chains of one operation that
``benchmarks/roofline_probe.py`` times; no verify path launches them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..crypto import ed25519 as _ref

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# Launches per kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {name: 0 for name in (
    "ed25519_verify", "ed25519_verify_comb", "ed25519_verify_packed", "ed25519_verify_f32",
    "ed25519_verify_f32_comb", "ed25519_verify_f32_mma", "ed25519_verify_f32_mma_comb",
    "fe_ops", "fe_ops_packed", "fe_ops_f32", "fe_mul_mma", "decompress", "comb_select",
    "ed25519_rlc", "ed25519_rlc_packed", "ed25519_rlc_f32", "ed25519_rlc_f32_mma",
    "rlc_fold", "rlc_fold_packed", "rlc_fold_f32",
    "pl_i32mul", "op_chain", "pl_femul8", "fe_mul_chain")}

# (field layout, comb, tensor-core fe_mul) -> verify kernel
VERIFY_KERNELS = {("int64", False, False): "ed25519_verify",
                  ("int64", True, False): "ed25519_verify_comb",
                  ("packed", False, False): "ed25519_verify_packed",
                  ("f32", False, False): "ed25519_verify_f32",
                  ("f32", True, False): "ed25519_verify_f32_comb",
                  ("f32", False, True): "ed25519_verify_f32_mma",
                  ("f32", True, True): "ed25519_verify_f32_mma_comb"}
# (field layout, tensor-core fe_mul) -> RLC kernel; field layout -> its fold
RLC_KERNELS = {("int64", False): "ed25519_rlc", ("packed", False): "ed25519_rlc_packed",
               ("f32", False): "ed25519_rlc_f32", ("f32", True): "ed25519_rlc_f32_mma"}
FOLD_KERNELS = {"int64": "rlc_fold", "packed": "rlc_fold_packed", "f32": "rlc_fold_f32"}
# field layout -> the dtype and limb count of a lane coordinate the RLC kernels write
LANE_LIMBS = {"int64": (torch.int64, 5), "packed": (torch.int32, 10), "f32": (torch.float32, 51)}

# op_chain's kinds (the chain kinds of the JAX package's roofline probe) ->
# (dtype, mask, kind code of tm_op_chain): floor and i32mul are pl_i32mul's
# x = (x * y) & 255, i64mul x = (x * y) & mask, i64add x = (x + y) & mask,
# f32mul x = x * y.  Integer inputs lie in [0, mask].
OP_CHAIN_KINDS = {"floor": (torch.int32, 255, 0), "i32mul": (torch.int32, 255, 0),
                  "i64mul": (torch.int64, (1 << 17) - 1, 1),
                  "i64add": (torch.int64, (1 << 17) - 1, 2), "f32mul": (torch.float32, 0, 3)}
FEMUL8_LIMBS = 32  # pl_femul8's limbs of 8 bits

# The RLC kernels' bucket method (csrc/ed25519_rlc.cuh): radix-16 windows
# of z*k (the first 32 also of z), digits 1..15 as buckets, and tasks of
# (window, digit, split of at most RLC_SPLIT_ROWS rows); one lane per window.
RLC_WINDOWS = 64
RLC_Z_WINDOWS = 32
RLC_BUCKETS = 15
RLC_SPLIT_ROWS = 16384
RLC_PLANES = RLC_WINDOWS + RLC_Z_WINDOWS  # digit planes of N bytes in scratch
RLC_STAGES = 3  # launches per RLC call: points, buckets, windows
RLC_MAX_LANES = 128  # rlc_fold folds the lanes to this many or fewer
COMB_SHAPE = (32, 256, 128)  # the comb table: window, digit, byte of X|Y|Z|T

# Field multiplies and squarings one row of each kernel performs (fixed:
# no loop depends on the data), as a host build of csrc/ counts them
# (TM_COUNT_FIELD_OPS; tests/test_torch_kernel_host.py holds these tables
# to that count).  An RLC kernel's row term is its two decompressions; its
# additions depend on the digits (``rlc_field_ops``).  A "row" of a fold
# is a lane it folds away.  The packed and f32 doublings square x + y with
# a multiply, as their JAX formulas do.  The comb takes 31 fixed-base
# additions instead of 63.  The counts are the work the data needs: the
# dummy additions that keep a warp's lanes together under the collective
# fe_mul, or that add the identity, are not in them.
_PT_ADD = (9, 0)
_PT_DBL_T = (4, 4)
_PT_DBL = (3, 4)
_PT_DBL_T_MUL = (5, 3)  # packed, f32
_PT_DBL_MUL = (4, 3)
_POW_P58 = (11, 251)
_DECOMPRESS = (9 + _POW_P58[0], 4 + _POW_P58[1])


def _ops(*terms):
    return (sum(c * m for c, (m, _) in terms), sum(c * s for c, (_, s) in terms))


def _verify_ops(base_adds: int, dbl, dbl_t):
    return _ops((2, _DECOMPRESS), (base_adds, _PT_ADD),                   # [s]B
                (14 + 63, _PT_ADD), (3 * 63, dbl), (63, dbl_t),           # [k](-A)
                (2, _PT_ADD), (3, dbl))


_FE_OPS = _ops((1, (1, 0)), (1, (0, 1)), (1, _POW_P58))
_RLC_ROW = _ops((2, _DECOMPRESS))  # A and R, one thread each
FIELD_OPS_PER_ROW = {
    "ed25519_verify": _verify_ops(63, _PT_DBL, _PT_DBL_T),
    "ed25519_verify_comb": _verify_ops(31, _PT_DBL, _PT_DBL_T),
    "ed25519_verify_packed": _verify_ops(63, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "ed25519_verify_f32": _verify_ops(63, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "ed25519_verify_f32_comb": _verify_ops(31, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "ed25519_verify_f32_mma": _verify_ops(63, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "ed25519_verify_f32_mma_comb": _verify_ops(31, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "fe_ops": _FE_OPS,
    "fe_ops_packed": _FE_OPS,
    "fe_ops_f32": _FE_OPS,
    "fe_mul_mma": (1, 0),
    "decompress": _ops((1, _DECOMPRESS)),
    **dict.fromkeys(RLC_KERNELS.values(), _RLC_ROW),
    **dict.fromkeys(FOLD_KERNELS.values(), _ops((1, _PT_ADD))),
}

# Per layout: the limb products of one multiply and of one squaring, as
# instructions of the pipe that bounds them.  5 x 51: a 51 x 51-bit
# product is four 32-bit multiply-adds (IMAD); packed: a 32 x 32 -> 64-bit
# product is one IMAD.WIDE.U32; f32: one FFMA per product.
LAYOUT_PRODUCTS = {"51": (4 * 25, 4 * 15, "imad"), "packed": (100, 55, "imad"),
                   "f32": (2601, 1326, "ffma")}
# The tensor-core fe_mul (csrc/fe_f32_mma.cuh) forms its limb products
# inside int8 mma: per row two n8 tiles x two k32 steps of m16n8k32, 16 x
# 8 x 32 multiply-adds of 2 operations each, and as many again for a row
# whose Toeplitz operand needs its high byte (none in the point formulas).
# Its squarings stay on the FP32 pipe, priced as the f32 layout's.
MMA_MUL_INT8_OPS = 2 * 2 * 16 * 8 * 32 * 2
MMA_KERNELS = ("ed25519_verify_f32_mma", "ed25519_verify_f32_mma_comb", "fe_mul_mma",
               "ed25519_rlc_f32_mma")


_LAYOUT = {"ed25519_verify_packed": "packed", "fe_ops_packed": "packed",
           "ed25519_rlc_packed": "packed", "rlc_fold_packed": "packed",
           **dict.fromkeys(("ed25519_verify_f32", "ed25519_verify_f32_comb", "fe_ops_f32",
                            "ed25519_rlc_f32", "rlc_fold_f32", *MMA_KERNELS), "f32")}


def layout(kernel: str) -> str:
    """The field layout of `kernel`'s limbs: "51", "packed" or "f32"."""
    return _LAYOUT.get(kernel, "51")


def reduced_width(n: int, target: int) -> int:
    """The width a pairwise fold of n lanes stops at: n halves, rounding
    up, until it is at most `target` (``_reduced_width`` of the JAX
    package)."""
    while n > target:
        n = n // 2 + n % 2
    return n


def rlc_lanes(n: int) -> int:
    """Lanes ``ed25519_rlc`` writes for n rows: one per window."""
    return RLC_WINDOWS if n else 0


def rlc_splits(n: int) -> int:
    """Row splits of each (window, digit) task of the RLC kernels."""
    return max(1, -(-n // RLC_SPLIT_ROWS))


def rlc_tasks(n: int) -> int:
    """Tasks (one warp each) of the RLC kernels' buckets launch."""
    return RLC_WINDOWS * RLC_BUCKETS * rlc_splits(n)


def _times_digit_ops(j: int, dbl, dbl_t) -> tuple[int, int]:
    """[j]b by double-and-add, most significant bit first (T formed only
    where an addition or the end follows)."""
    terms = []
    for bit in range(j.bit_length() - 2, -1, -1):
        add = (j >> bit) & 1
        terms.append((1, dbl_t if add or bit == 0 else dbl))
        if add:
            terms.append((1, _PT_ADD))
    return _ops(*terms)


def rlc_field_ops(kernel: str, zk_rows, z_rows, prevalid) -> tuple[int, int]:
    """(multiplies, squarings) the RLC kernel `kernel` needs for these rows
    (zk uint8 [N, 32], z uint8 [N, 16], prevalid bool [N]): two
    decompressions a row; per non-empty (window, digit j, split) task of k
    points, k - 1 additions and [j]; per non-empty window of t tasks,
    t - 1 additions and 4w doublings."""
    zk, z = np.asarray(zk_rows, dtype=np.uint8), np.asarray(z_rows, dtype=np.uint8)
    ok = np.asarray(prevalid, dtype=bool)
    n = len(ok)
    if n == 0:
        return 0, 0
    dbl, dbl_t = ((_PT_DBL, _PT_DBL_T) if layout(kernel) == "51"
                  else (_PT_DBL_MUL, _PT_DBL_T_MUL))
    digits = [np.where(ok[:, None], np.stack([d & 15, d >> 4], axis=-1).reshape(n, -1), 0)
              for d in (zk, z)]
    terms = [(2 * n, _DECOMPRESS)]
    splits = rlc_splits(n)
    for w in range(RLC_WINDOWS):
        tasks = 0
        for r in range(splits):
            rows = slice(r * n // splits, (r + 1) * n // splits)
            counts = sum(np.bincount(d[rows, w], minlength=16) for d in digits
                         if w < d.shape[1])
            for j in range(1, 16):
                if counts[j]:
                    tasks += 1
                    terms += [(int(counts[j]) - 1, _PT_ADD),
                              (1, _times_digit_ops(j, dbl, dbl_t))]
        if tasks:
            terms += [(tasks - 1, _PT_ADD), (max(4 * w - 1, 0), dbl), (min(w, 1), dbl_t)]
    return _ops(*terms)


def field_ops(kernel: str, n: int, rlc_inputs=None) -> tuple[int, int]:
    """(multiplies, squarings) of one call of `kernel` on n rows (for a
    fold, n lanes); an RLC kernel's depend on its inputs, `rlc_inputs` =
    (zk rows, z rows, prevalid)."""
    if kernel in RLC_KERNELS.values():
        if rlc_inputs is None:
            raise ValueError(f"{kernel}'s work depends on its digits: pass rlc_inputs")
        return rlc_field_ops(kernel, *rlc_inputs)
    rows = n - reduced_width(n, RLC_MAX_LANES) if kernel in FOLD_KERNELS.values() else n
    muls, sqs = FIELD_OPS_PER_ROW[kernel]
    return rows * muls, rows * sqs


def operations(kernel: str, n: int, rlc_inputs=None, high_muls: int = 0) -> dict[str, int]:
    """The limb products of one call of `kernel` on n rows, as
    instructions (operations, for "int8_mma") per pipe: the counts its
    bound is computed from, the larger time over the pipes.  An mma
    kernel's multiplies are the int8 operations its mma issue, those of
    the `high_muls` multiplies that need the Toeplitz operand's high byte
    twice over (``fe25519_f32.mxu_high_rows`` counts them for raw
    operands; the verify and RLC kernels' point formulas need none), and
    its squarings FFMA; so its bound is never above the FFMA kernel's for
    the same rows."""
    muls, sqs = field_ops(kernel, n, rlc_inputs)
    per_mul, per_sq, pipe = LAYOUT_PRODUCTS[layout(kernel)]
    if kernel not in MMA_KERNELS:
        return {pipe: per_mul * muls + per_sq * sqs}
    return {"ffma": per_sq * sqs, "int8_mma": MMA_MUL_INT8_OPS * (muls + high_muls)}


# The card's peak rates the bounds are priced with (H100 SXM): device
# memory, and per SM per clock, compute capability 9.0 (CUDA C programming
# guide's throughput table), the 32-bit integer multiply-add (IMAD), the
# FP32 multiply and fused multiply-add, and the 32-bit integer add,
# logical, shift and compare; dense int8 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PIPE_PER_SM_PER_CLK = {"imad": 64, "ffma": 128, "alu": 64}
INT8_TENSOR_OPS_PER_S = 1.979e15


def pipe_rates(sms: int, clock_mhz: float) -> dict[str, float]:
    """Instructions per second of each pipe on `sms` SMs at `clock_mhz`,
    and the int8 tensor-core operations."""
    rates = {pipe: sms * per_clk * clock_mhz * 1e6
             for pipe, per_clk in PIPE_PER_SM_PER_CLK.items()}
    rates["int8_mma"] = INT8_TENSOR_OPS_PER_S
    return rates


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _sources() -> list[Path]:
    """What nvcc compiles: one object per ``.cu``."""
    return sorted(CSRC.glob("*.cu"))


def _hashed_sources() -> list[Path]:
    """What the library's name hashes: the ``.cu`` files and the headers
    they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256()
    for src in _hashed_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libtm_kernels-{h.hexdigest()[:16]}.so"


def compile_command(nvcc: str, src: Path, obj: Path) -> list[str]:
    """The nvcc command that compiles one source to an object for the
    library: the same for every source, with ptxas at its default level
    and its register and spill report (-v)."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(obj), str(src)]


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all at once, then one link.  The compilers' register
    and spill reports go to ``<library>.log``, each source's after a line
    ``nvcc <source>: <seconds> s`` (``compile_seconds`` reads them)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    nvcc = _nvcc()
    objs = [Path(f"{stem}.{src.stem}.o") for src in _sources()]
    src_logs = [Path(f"{stem}.{src.stem}.log") for src in _sources()]
    start = time.perf_counter()
    compiles = []
    for src, obj, log in zip(_sources(), objs, src_logs):
        with open(log, "w") as f:
            compiles.append(subprocess.Popen(compile_command(nvcc, src, obj), stdout=f,
                                             stderr=subprocess.STDOUT))
    seconds = [None] * len(compiles)
    while None in seconds:
        for i, proc in enumerate(compiles):
            if seconds[i] is None and proc.poll() is not None:
                seconds[i] = time.perf_counter() - start
        time.sleep(0.05)
    logs = [f"nvcc {src.name}: {t:.1f} s\n" + log.read_text()
            for src, t, log in zip(_sources(), seconds, src_logs)]
    for log in src_logs:
        log.unlink()
    failed = [(src.name, proc.returncode, log) for src, proc, log in
              zip(_sources(), compiles, logs) if proc.returncode != 0]
    if not failed:
        tmp = Path(f"{stem}.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, link.stdout + link.stderr))
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        name, code, log = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({code}):\n{log[-4000:]}")
    os.replace(tmp, out)
    return out


def compile_seconds(log_text: str) -> dict[str, float]:
    """Each source's nvcc wall time, from a build log ``build`` wrote."""
    return {line.split()[1].rstrip(":"): float(line.split()[2])
            for line in log_text.splitlines() if line.startswith("nvcc ")}


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in VERIFY_KERNELS.values():
        getattr(lib, f"tm_{name}").argtypes = [p, p, p, p, p, p, p, i, p]
    for name in ("fe_ops", "fe_ops_packed", "fe_ops_f32"):
        getattr(lib, f"tm_{name}").argtypes = [p, p, p, p, p, i, p]
    lib.tm_fe_mul_mma.argtypes = [p, p, p, i, p]
    lib.tm_decompress.argtypes = [p, p, p, i, p]
    lib.tm_comb_select.argtypes = [p, p, p, i, p]
    for name in RLC_KERNELS.values():
        getattr(lib, f"tm_{name}").argtypes = [i, *[p] * 12, i, p]
    for name in FOLD_KERNELS.values():
        getattr(lib, f"tm_{name}").argtypes = [p, p, i, p]
    lib.tm_op_chain.argtypes = [p, p, p, i, i, i, ctypes.c_longlong, p]
    lib.tm_pl_femul8.argtypes = [p, p, p, i, i, i, p]
    lib.tm_fe_mul_chain.argtypes = [p, p, p, i, i, p]
    for name in LAUNCHES.keys() - {"pl_i32mul"}:  # pl_i32mul launches through tm_op_chain
        getattr(lib, f"tm_{name}").restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The fixed-base table in the kernel's layout
# ---------------------------------------------------------------------------

LIMB51 = (1 << 51) - 1


def limbs51(v: int) -> list[int]:
    """A field element as the kernel's 5 x 51-bit limbs, reduced mod p."""
    v %= _ref.P
    return [(v >> (51 * i)) & LIMB51 for i in range(5)]


def table_from_points(rows) -> np.ndarray:
    """[64][16] big-int extended points -> int64 [64, 16, 4, 5], the
    layout ``ed25519_verify`` reads: window, digit, coordinate (X, Y, Z,
    T), limb."""
    out = np.zeros((64, 16, 4, 5), dtype=np.int64)
    for i, row in enumerate(rows):
        for j, point in enumerate(row):
            for c in range(4):
                out[i, j, c] = limbs51(point[c])
    return out


@functools.cache
def base_table(device: torch.device) -> torch.Tensor:
    """[j * 16^i]B in the kernel's layout on `device`, built once."""
    return torch.as_tensor(table_from_points(_ref.base_point_table()), device=device)


def comb_table_from_points(rows) -> np.ndarray:
    """[32][256] big-int extended points -> uint8 [32, 256, 128], the
    comb's layout: window, digit, byte of the canonical X | Y | Z | T
    encodings.  Entry-contiguous, the JAX table's order: a lane reads its
    entry as eight 16-byte words."""
    out = np.zeros((32, 256, 128), dtype=np.uint8)
    for i, row in enumerate(rows):
        for j, point in enumerate(row):
            enc = b"".join((c % _ref.P).to_bytes(32, "little") for c in point)
            out[i, j] = np.frombuffer(enc, dtype=np.uint8)
    return out


@functools.cache
def comb_table(device: torch.device) -> torch.Tensor:
    """[j * 256^i]B in the comb's layout on `device`, built once (1 MiB)."""
    return torch.as_tensor(comb_table_from_points(_ref.base_point_table256()), device=device)


# ---------------------------------------------------------------------------
# Wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# the table each verify kernel reads
_TABLES = {"ed25519_verify": (torch.int64, (64, 16, 4, 5)),
           "ed25519_verify_packed": (torch.int32, (64, 16, 4, 10)),
           "ed25519_verify_f32": (torch.float32, (64, 16, 4, 51)),
           "ed25519_verify_f32_mma": (torch.float32, (64, 16, 4, 51)),
           "ed25519_verify_comb": (torch.uint8, COMB_SHAPE),
           "ed25519_verify_f32_comb": (torch.uint8, COMB_SHAPE),
           "ed25519_verify_f32_mma_comb": (torch.uint8, COMB_SHAPE)}


def _verify(kernel: str, pub, r, s, k, valid, table) -> torch.Tensor:
    """bool [N] verdicts from one launch of a verify kernel: packed rows
    uint8 [N, 32] x 4, valid bool [N] and the kernel's table."""
    n = pub.shape[0]
    dev = pub.device
    for name, t in (("pub", pub), ("r", r), ("s", s), ("k", k)):
        _check(t, name, torch.uint8, (n, 32), dev)
    _check(valid, "valid", torch.bool, (n,), dev)
    _check(table, "table", *_TABLES[kernel], dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = getattr(library(), f"tm_{kernel}")(
                pub.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(), valid.data_ptr(),
                table.data_ptr(), out.data_ptr(), n, _stream(dev))
        _raise_on(err, kernel)
        LAUNCHES[kernel] += 1
    return out


def verify(impl: str, base_mxu: bool = False, fe_mxu: bool = False):
    """The wrapper of the verify kernel for field layout `impl` (with the
    comb where `base_mxu`, with the tensor-core fe_mul where `fe_mxu`); it
    takes (pub, r, s, k, valid, table)."""
    try:
        return functools.partial(_verify, VERIFY_KERNELS[(impl, base_mxu, fe_mxu)])
    except KeyError:
        raise ValueError(f"no verify kernel for impl={impl!r}, base_mxu={base_mxu}, "
                         f"fe_mxu={fe_mxu}") from None


def ed25519_verify(pub, r, s, k, valid, table) -> torch.Tensor:
    """5 x 51-bit limbs; the fixed-base table int64 [64, 16, 4, 5]
    (``base_table``)."""
    return _verify("ed25519_verify", pub, r, s, k, valid, table)


def _fe_ops(kernel: str, a, b):
    n = a.shape[0]
    dev = a.device
    _check(a, "a", torch.uint8, (n, 32), dev)
    _check(b, "b", torch.uint8, (n, 32), dev)
    outs = [torch.empty((n, 32), dtype=torch.uint8, device=dev) for _ in range(3)]
    if n:
        with torch.cuda.device(dev):
            err = getattr(library(), f"tm_{kernel}")(a.data_ptr(), b.data_ptr(),
                                                     *(o.data_ptr() for o in outs), n,
                                                     _stream(dev))
        _raise_on(err, kernel)
        LAUNCHES[kernel] += 1
    return tuple(outs)


def fe_ops(a, b):
    """From 255-bit encodings a, b (uint8 [N, 32]): canonical a*b, a^2 and
    a^((p-5)/8), each uint8 [N, 32], in 5 x 51-bit limbs."""
    return _fe_ops("fe_ops", a, b)


def fe_ops_packed(a, b):
    """``fe_ops`` in 10 x 25.5-bit limbs."""
    return _fe_ops("fe_ops_packed", a, b)


def fe_ops_f32(a, b):
    """``fe_ops`` in 51 x 5-bit float limbs."""
    return _fe_ops("fe_ops_f32", a, b)


def fe_mul_mma(a, b):
    """The tensor-core fe_mul alone: from raw f32 limbs a, b (float32
    [N, 51], within fe_mul's contract |a|_inf * |b|_inf <= 17,641), the
    carried limbs of a * b, float32 [N, 51]."""
    n = a.shape[0]
    dev = a.device
    _check(a, "a", torch.float32, (n, 51), dev)
    _check(b, "b", torch.float32, (n, 51), dev)
    out = torch.empty((n, 51), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = library().tm_fe_mul_mma(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                          _stream(dev))
        _raise_on(err, "fe_mul_mma")
        LAUNCHES["fe_mul_mma"] += 1
    return out


def comb_select(s, table):
    """The comb's selection alone: for packed s rows uint8 [N, 32] and the
    comb table uint8 [32, 256, 128], the entry each row
    selects in each window, uint8 [N, 32, 128] (canonical X | Y | Z | T
    of [s_w * 256^w]B)."""
    n = s.shape[0]
    dev = s.device
    _check(s, "s", torch.uint8, (n, 32), dev)
    _check(table, "table", torch.uint8, COMB_SHAPE, dev)
    out = torch.empty((n, 32, 128), dtype=torch.uint8, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = library().tm_comb_select(s.data_ptr(), table.data_ptr(), out.data_ptr(), n,
                                           _stream(dev))
        _raise_on(err, "comb_select")
        LAUNCHES["comb_select"] += 1
    return out


def decompress(enc):
    """From encodings uint8 [N, 32]: canonical (x, y) uint8 [N, 2, 32] and
    the on-curve flag bool [N]."""
    n = enc.shape[0]
    dev = enc.device
    _check(enc, "enc", torch.uint8, (n, 32), dev)
    xy = torch.empty((n, 2, 32), dtype=torch.uint8, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = library().tm_decompress(enc.data_ptr(), xy.data_ptr(), ok.data_ptr(), n,
                                          _stream(dev))
        _raise_on(err, "decompress")
        LAUNCHES["decompress"] += 1
    return xy, ok


def _rlc(kernel: str, impl: str, pub, r, zk, z, valid, stage_events=None):
    n = pub.shape[0]
    dev = pub.device
    for name, t in (("pub", pub), ("r", r), ("zk", zk)):
        _check(t, name, torch.uint8, (n, 32), dev)
    _check(z, "z", torch.uint8, (n, 16), dev)
    _check(valid, "valid", torch.bool, (n,), dev)
    dtype, limbs = LANE_LIMBS[impl]
    lanes = torch.empty((rlc_lanes(n), 4, limbs), dtype=dtype, device=dev)
    prevalid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        scratch = (torch.empty((2 * n, 4, limbs), dtype=dtype, device=dev),  # -A, -R
                   torch.empty(2 * n, dtype=torch.uint8, device=dev),  # on the curve
                   torch.empty(RLC_PLANES * n, dtype=torch.uint8, device=dev),  # digits
                   torch.empty((rlc_tasks(n), 4, limbs), dtype=dtype, device=dev),  # [j]B
                   torch.empty(rlc_tasks(n), dtype=torch.int32, device=dev))  # points a task
        entry = getattr(library(), f"tm_{kernel}")
        with torch.cuda.device(dev):
            for stage in range(RLC_STAGES):
                if stage_events:
                    stage_events[stage].record()
                err = entry(stage, pub.data_ptr(), r.data_ptr(), zk.data_ptr(), z.data_ptr(),
                            valid.data_ptr(), lanes.data_ptr(), prevalid.data_ptr(),
                            *(t.data_ptr() for t in scratch), n, _stream(dev))
                _raise_on(err, kernel)
                LAUNCHES[kernel] += 1
            if stage_events:
                stage_events[RLC_STAGES].record()
    return lanes, prevalid


def rlc(impl: str = "int64", fe_mxu: bool = False):
    """The wrapper of the RLC kernel for field layout `impl` (with the
    tensor-core fe_mul where `fe_mxu`): from packed rows pub, r, zk (uint8
    [N, 32]), z (uint8 [N, 16]) and valid (bool [N]), the lanes, one per
    radix-16 window (X, Y, Z, T in the layout's limbs: ``LANE_LIMBS``),
    and prevalid, bool [N].  Three launches (``RLC_STAGES``), each counted;
    with `stage_events`, RLC_STAGES + 1 CUDA events, they are recorded
    around them."""
    try:
        return functools.partial(_rlc, RLC_KERNELS[(impl, fe_mxu)], impl)
    except KeyError:
        raise ValueError(f"no RLC kernel for impl={impl!r}, fe_mxu={fe_mxu}") from None


def ed25519_rlc(pub, r, zk, z, valid):
    """The RLC kernel in 5 x 51-bit limbs: lanes int64 [64, 4, 5] and
    prevalid."""
    return _rlc("ed25519_rlc", "int64", pub, r, zk, z, valid)


def rlc_fold(lanes):
    """Lanes [P, 4, limbs] of any layout (its ``LANE_LIMBS``, which picks
    the fold) folded pairwise to [reduced_width(P, 128), 4, limbs], with
    the same sum."""
    p = lanes.shape[0]
    dev = lanes.device
    impl = next((i for i, (dtype, limbs) in LANE_LIMBS.items()
                 if lanes.dtype == dtype and lanes.shape[-1:] == (limbs,)), "int64")
    kernel = FOLD_KERNELS[impl]
    dtype, limbs = LANE_LIMBS[impl]
    _check(lanes, "lanes", dtype, (p, 4, limbs), dev)
    work = torch.empty_like(lanes)
    if p:
        with torch.cuda.device(dev):
            err = getattr(library(), f"tm_{kernel}")(lanes.data_ptr(), work.data_ptr(), p,
                                                     _stream(dev))
        _raise_on(err, kernel)
        LAUNCHES[kernel] += 1
    return work[:reduced_width(p, RLC_MAX_LANES)]


def _chain(kernel: str, x, y, chain: int, dtype: torch.dtype, shape: tuple, n: int, *args,
           entry: str | None = None):
    """One launch of a probe kernel on x, y (`dtype`, `shape`, n threads),
    through ``tm_<entry>`` (by default ``tm_<kernel>``) and counted under
    `kernel`: `chain` steps of its operation, into a new tensor like x;
    `args` go between the chain length and the stream."""
    dev = x.device
    _check(x, "x", dtype, shape, dev)
    _check(y, "y", dtype, shape, dev)
    if chain < 0:
        raise ValueError(f"{kernel}: chain must be >= 0, got {chain}")
    out = torch.empty_like(x)
    if n:
        with torch.cuda.device(dev):
            err = getattr(library(), f"tm_{entry or kernel}")(
                x.data_ptr(), y.data_ptr(), out.data_ptr(), n, chain, *args, _stream(dev))
        _raise_on(err, kernel)
        LAUNCHES[kernel] += 1
    return out


def pl_i32mul(x, y, chain: int):
    """`chain` steps of x = (x * y) & 255 on int32 [rows, 128], values in
    [0, 255]: the JAX package's Pallas probe ``pl_i32mul``, launched as
    op_chain's i32mul instance and counted as ``pl_i32mul``."""
    _, mask, code = OP_CHAIN_KINDS["i32mul"]
    return _chain("pl_i32mul", x, y, chain, torch.int32, (x.shape[0], 128), x.numel(), code,
                  mask, entry="op_chain")


def op_chain(kind: str, x, y, chain: int):
    """`chain` steps of the operation of `kind` (``OP_CHAIN_KINDS``) on
    x, y of its dtype, any shape."""
    try:
        dtype, mask, code = OP_CHAIN_KINDS[kind]
    except KeyError:
        raise ValueError(f"no op_chain kind {kind!r}") from None
    return _chain("op_chain", x, y, chain, dtype, tuple(x.shape), x.numel(), code, mask)


def pl_femul8(x, y, chain: int, limb_major: bool = True):
    """`chain` steps of x = fe_mul8(x, y), limbs of 8 bits (int32, each
    < 2^10) in the limb-major layout [32, N] of the JAX package's Pallas
    probe ``pl_femul8`` or, with `limb_major` False, row-major [N, 32]
    (its chain probe ``femul8``)."""
    n = x.shape[-1] if limb_major else x.shape[0]
    shape = (FEMUL8_LIMBS, n) if limb_major else (n, FEMUL8_LIMBS)
    return _chain("pl_femul8", x, y, chain, torch.int32, shape, n, int(limb_major))


def fe_mul_chain(x, y, chain: int):
    """`chain` steps of x = fe_mul(x, y), the 5 x 51-bit multiply of the
    verify kernels, on int64 [N, 5] limbs (each < 2^52)."""
    return _chain("fe_mul_chain", x, y, chain, torch.int64, (x.shape[0], 5), x.shape[0])
