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
``csrc/ed25519_rlc.cuh``.  Every source includes the curve pipeline of
``csrc/ed25519_common.cuh``; the comb's tensor-core selection is
``csrc/base_comb.cuh``.
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
    "rlc_fold", "rlc_fold_packed", "rlc_fold_f32")}

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

RLC_THREADS = 64  # rows per block of ed25519_rlc; each block writes one lane
RLC_MAX_LANES = 128  # rlc_fold folds the lanes to this many or fewer
COMB_SHAPE = (32, 128, 256)  # the comb table: window, byte of X|Y|Z|T, digit

# Field multiplies and squarings one row of each kernel performs (fixed:
# no loop depends on the data), as a host build of csrc/ counts them
# (TM_COUNT_FIELD_OPS; tests/test_torch_kernel_host.py holds these tables
# to that count).  The RLC kernels add a per-block term for the tree and
# the block's Horner chain; a "row" of a fold is a lane it folds away.  The
# packed and f32 doublings square x + y with a multiply, as their JAX
# formulas do.  The comb takes 31 fixed-base additions instead of 63.
# The counts are the work a row needs: the dummy additions that keep a
# warp's lanes together under the collective fe_mul are not in them.
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
_RLC_ROW = _ops((2, _DECOMPRESS), (2 * 14, _PT_ADD),  # tables of -A, -R
               (32, _PT_ADD))                        # + [z_w](-R), w < 32
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
FIELD_OPS_PER_BLOCK = {  # 64 windows of: a tree over the block's rows, then Horner
    name: _ops((64 * (RLC_THREADS - 1), _PT_ADD), (64 * 3, dbl), (64, dbl_t), (64, _PT_ADD))
    for name, dbl, dbl_t in (("ed25519_rlc", _PT_DBL, _PT_DBL_T),
                             ("ed25519_rlc_packed", _PT_DBL_MUL, _PT_DBL_T_MUL),
                             ("ed25519_rlc_f32", _PT_DBL_MUL, _PT_DBL_T_MUL),
                             ("ed25519_rlc_f32_mma", _PT_DBL_MUL, _PT_DBL_T_MUL))}

# Per layout: the limb products of one multiply and of one squaring, as
# instructions of the pipe that bounds them.  5 x 51: a 51 x 51-bit
# product is four 32-bit multiply-adds (IMAD); packed: a 32 x 32 -> 64-bit
# product is one IMAD.WIDE.U32; f32: one FFMA per product.
LAYOUT_PRODUCTS = {"51": (4 * 25, 4 * 15, "imad"), "packed": (100, 55, "imad"),
                   "f32": (2601, 1326, "ffma")}
# The tensor-core fe_mul (csrc/fe_f32_mma.cuh): its 2,601 limb products
# (a_i * b_j + 128, exact below 2^24) are priced as one FFMA each, the
# fastest pipe that forms them exactly (the kernel uses IMAD), and its
# contraction is 88 (k32 step, n8 tile) pairs of two m16n8k32 int8 mma (hi
# and lo bytes) per 32 rows: 2 x 88 x 32 x 8 multiply-adds, 2 operations
# each, per row.
MMA_MUL_INT8_OPS = 2 * 88 * 32 * 8 * 2
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
    """Lanes ``ed25519_rlc`` writes for n rows: one per block."""
    return -(-n // RLC_THREADS)


def field_ops(kernel: str, n: int) -> tuple[int, int]:
    """(multiplies, squarings) of one launch of `kernel` on n rows (for a
    fold, n lanes)."""
    rows = n - reduced_width(n, RLC_MAX_LANES) if kernel in FOLD_KERNELS.values() else n
    muls, sqs = FIELD_OPS_PER_ROW[kernel]
    block_muls, block_sqs = FIELD_OPS_PER_BLOCK.get(kernel, (0, 0))
    blocks = rlc_lanes(n) if kernel in FIELD_OPS_PER_BLOCK else 0
    return rows * muls + blocks * block_muls, rows * sqs + blocks * block_sqs


def operations(kernel: str, n: int) -> dict[str, int]:
    """The limb products of one launch of `kernel` on n rows, as
    instructions (operations, for "int8_mma") per pipe: the counts its
    bound is computed from, the larger time over the pipes.  An mma
    kernel's multiplies form their products on the FP32 pipe, beside its
    squarings, and sum them on the tensor cores, so its bound is never
    above the FFMA kernel's for the same rows."""
    muls, sqs = field_ops(kernel, n)
    per_mul, per_sq, pipe = LAYOUT_PRODUCTS[layout(kernel)]
    if kernel not in MMA_KERNELS:
        return {pipe: per_mul * muls + per_sq * sqs}
    return {"ffma": per_mul * muls + per_sq * sqs, "int8_mma": MMA_MUL_INT8_OPS * muls}


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
            compiles.append(subprocess.Popen(
                [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", str(obj), str(src)], stdout=f, stderr=subprocess.STDOUT))
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
        getattr(lib, f"tm_{name}").argtypes = [p, p, p, p, p, p, p, i, p]
    for name in FOLD_KERNELS.values():
        getattr(lib, f"tm_{name}").argtypes = [p, p, i, p]
    for name in LAUNCHES:
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
    """[32][256] big-int extended points -> uint8 [32, 128, 256], the
    comb's layout: window, byte of the canonical X | Y | Z | T encodings,
    digit.  Column-major per window, so the tensor cores' B operand (four
    digits of one byte) is one aligned 32-bit load."""
    out = np.zeros((256, 32, 128), dtype=np.uint8)
    for i, row in enumerate(rows):
        for j, point in enumerate(row):
            enc = b"".join((c % _ref.P).to_bytes(32, "little") for c in point)
            out[j, i] = np.frombuffer(enc, dtype=np.uint8)
    return np.ascontiguousarray(out.transpose(1, 2, 0))


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
    """The comb's tensor-core selection alone: for packed s rows uint8
    [N, 32] and the comb table uint8 [32, 128, 256], the entry each row
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


def _rlc(kernel: str, impl: str, pub, r, zk, z, valid):
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
        with torch.cuda.device(dev):
            err = getattr(library(), f"tm_{kernel}")(
                pub.data_ptr(), r.data_ptr(), zk.data_ptr(), z.data_ptr(), valid.data_ptr(),
                lanes.data_ptr(), prevalid.data_ptr(), n, _stream(dev))
        _raise_on(err, kernel)
        LAUNCHES[kernel] += 1
    return lanes, prevalid


def rlc(impl: str = "int64", fe_mxu: bool = False):
    """The wrapper of the RLC kernel for field layout `impl` (with the
    tensor-core fe_mul where `fe_mxu`): from packed rows pub, r, zk (uint8
    [N, 32]), z (uint8 [N, 16]) and valid (bool [N]), the lanes, one per
    block of 64 rows (X, Y, Z, T in the layout's limbs: ``LANE_LIMBS``),
    and prevalid, bool [N]."""
    try:
        return functools.partial(_rlc, RLC_KERNELS[(impl, fe_mxu)], impl)
    except KeyError:
        raise ValueError(f"no RLC kernel for impl={impl!r}, fe_mxu={fe_mxu}") from None


def ed25519_rlc(pub, r, zk, z, valid):
    """The RLC kernel in 5 x 51-bit limbs: lanes int64
    [ceil(N / 64), 4, 5] and prevalid."""
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
