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
(``csrc/ed25519_verify_f32.cu``, 51 x 5-bit float limbs); ``ed25519_rlc``
and ``rlc_fold`` (``csrc/ed25519_rlc.cu``).  Every source includes the
curve pipeline of ``csrc/ed25519_common.cuh``; the comb's tensor-core
selection is ``csrc/base_comb.cuh``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
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
    "ed25519_verify_f32_comb", "fe_ops", "fe_ops_packed", "fe_ops_f32", "decompress",
    "comb_select", "ed25519_rlc", "rlc_fold")}

RLC_THREADS = 64  # rows per block of ed25519_rlc; each block writes one lane
RLC_MAX_LANES = 128  # rlc_fold folds the lanes to this many or fewer
COMB_SHAPE = (32, 128, 256)  # the comb table: window, byte of X|Y|Z|T, digit

# Field multiplies and squarings one row of each kernel performs (fixed:
# no loop depends on the data), as a host build of csrc/ counts them
# (TM_COUNT_FIELD_OPS; tests/test_torch_kernel_host.py holds these tables
# to that count).  ed25519_rlc adds a per-block term for the tree and the
# block's Horner chain; a "row" of rlc_fold is a lane it folds away.  The
# packed and f32 doublings square x + y with a multiply, as their JAX
# formulas do.  The comb takes 31 fixed-base additions instead of 63.
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
FIELD_OPS_PER_ROW = {
    "ed25519_verify": _verify_ops(63, _PT_DBL, _PT_DBL_T),
    "ed25519_verify_comb": _verify_ops(31, _PT_DBL, _PT_DBL_T),
    "ed25519_verify_packed": _verify_ops(63, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "ed25519_verify_f32": _verify_ops(63, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "ed25519_verify_f32_comb": _verify_ops(31, _PT_DBL_MUL, _PT_DBL_T_MUL),
    "fe_ops": _FE_OPS,
    "fe_ops_packed": _FE_OPS,
    "fe_ops_f32": _FE_OPS,
    "decompress": _ops((1, _DECOMPRESS)),
    "ed25519_rlc": _ops((2, _DECOMPRESS), (2 * 14, _PT_ADD),          # tables of -A, -R
                        (32, _PT_ADD)),                               # + [z_w](-R), w < 32
    "rlc_fold": _ops((1, _PT_ADD)),
}
FIELD_OPS_PER_BLOCK = {  # 64 windows of: a tree over the block's rows, then Horner
    "ed25519_rlc": _ops((64 * (RLC_THREADS - 1), _PT_ADD),
                        (64 * 3, _PT_DBL), (64, _PT_DBL_T), (64, _PT_ADD)),
}

# Per layout: the limb products of one multiply and of one squaring, as
# instructions of the pipe that bounds them.  5 x 51: a 51 x 51-bit
# product is four 32-bit multiply-adds (IMAD); packed: a 32 x 32 -> 64-bit
# product is one IMAD.WIDE.U32; f32: one FFMA per product.
LAYOUT_PRODUCTS = {"51": (4 * 25, 4 * 15, "imad"), "packed": (100, 55, "imad"),
                   "f32": (2601, 1326, "ffma")}


_LAYOUT = {"ed25519_verify_packed": "packed", "fe_ops_packed": "packed",
           "ed25519_verify_f32": "f32", "ed25519_verify_f32_comb": "f32", "fe_ops_f32": "f32"}


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
    """(multiplies, squarings) of one launch of `kernel` on n rows (for
    ``rlc_fold``, n lanes)."""
    rows = n - reduced_width(n, RLC_MAX_LANES) if kernel == "rlc_fold" else n
    muls, sqs = FIELD_OPS_PER_ROW[kernel]
    block_muls, block_sqs = FIELD_OPS_PER_BLOCK.get(kernel, (0, 0))
    blocks = rlc_lanes(n) if kernel in FIELD_OPS_PER_BLOCK else 0
    return rows * muls + blocks * block_muls, rows * sqs + blocks * block_sqs


def operations(kernel: str, n: int) -> tuple[int, str]:
    """(instructions, pipe) of the limb products of one launch of `kernel`
    on n rows: the operation count its bound is computed from."""
    muls, sqs = field_ops(kernel, n)
    per_mul, per_sq, pipe = LAYOUT_PRODUCTS[layout(kernel)]
    return per_mul * muls + per_sq * sqs, pipe


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
    and spill reports go to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    nvcc = _nvcc()
    objs = [Path(f"{stem}.{src.stem}.o") for src in _sources()]
    compiles = [subprocess.Popen([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
                                  "-fPIC", "-Xptxas", "-v", "-o", str(obj), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(_sources(), objs)]
    logs = [proc.communicate()[0] for proc in compiles]
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


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in VERIFY_KERNELS.values():
        getattr(lib, f"tm_{name}").argtypes = [p, p, p, p, p, p, p, i, p]
    for name in ("fe_ops", "fe_ops_packed", "fe_ops_f32"):
        getattr(lib, f"tm_{name}").argtypes = [p, p, p, p, p, i, p]
    lib.tm_decompress.argtypes = [p, p, p, i, p]
    lib.tm_comb_select.argtypes = [p, p, p, i, p]
    lib.tm_ed25519_rlc.argtypes = [p, p, p, p, p, p, p, i, p]
    lib.tm_rlc_fold.argtypes = [p, p, i, p]
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


# (field layout, comb) -> verify kernel; the table each one reads
VERIFY_KERNELS = {("int64", False): "ed25519_verify", ("int64", True): "ed25519_verify_comb",
                  ("packed", False): "ed25519_verify_packed",
                  ("f32", False): "ed25519_verify_f32", ("f32", True): "ed25519_verify_f32_comb"}
_TABLES = {"ed25519_verify": (torch.int64, (64, 16, 4, 5)),
           "ed25519_verify_packed": (torch.int32, (64, 16, 4, 10)),
           "ed25519_verify_f32": (torch.float32, (64, 16, 4, 51)),
           "ed25519_verify_comb": (torch.uint8, COMB_SHAPE),
           "ed25519_verify_f32_comb": (torch.uint8, COMB_SHAPE)}


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


def verify(impl: str, base_mxu: bool = False):
    """The wrapper of the verify kernel for field layout `impl` (with the
    comb where `base_mxu`); it takes (pub, r, s, k, valid, table)."""
    try:
        return functools.partial(_verify, VERIFY_KERNELS[(impl, base_mxu)])
    except KeyError:
        raise ValueError(f"no verify kernel for impl={impl!r}, base_mxu={base_mxu}") from None


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


def ed25519_rlc(pub, r, zk, z, valid):
    """The RLC batch equation's partial sums for packed rows pub, r, zk
    (uint8 [N, 32]), z (uint8 [N, 16]) and valid (bool [N]): the lanes,
    int64 [ceil(N / 64), 4, 5] (one per block of 64 rows: X, Y, Z, T in
    the kernel's 51-bit limbs), and prevalid, bool [N]."""
    n = pub.shape[0]
    dev = pub.device
    for name, t in (("pub", pub), ("r", r), ("zk", zk)):
        _check(t, name, torch.uint8, (n, 32), dev)
    _check(z, "z", torch.uint8, (n, 16), dev)
    _check(valid, "valid", torch.bool, (n,), dev)
    lanes = torch.empty((rlc_lanes(n), 4, 5), dtype=torch.int64, device=dev)
    prevalid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = library().tm_ed25519_rlc(pub.data_ptr(), r.data_ptr(), zk.data_ptr(),
                                           z.data_ptr(), valid.data_ptr(), lanes.data_ptr(),
                                           prevalid.data_ptr(), n, _stream(dev))
        _raise_on(err, "ed25519_rlc")
        LAUNCHES["ed25519_rlc"] += 1
    return lanes, prevalid


def rlc_fold(lanes):
    """Lanes int64 [P, 4, 5] folded pairwise to
    [reduced_width(P, 128), 4, 5], with the same sum."""
    p = lanes.shape[0]
    dev = lanes.device
    _check(lanes, "lanes", torch.int64, (p, 4, 5), dev)
    work = torch.empty_like(lanes)
    if p:
        with torch.cuda.device(dev):
            err = library().tm_rlc_fold(lanes.data_ptr(), work.data_ptr(), p, _stream(dev))
        _raise_on(err, "rlc_fold")
        LAUNCHES["rlc_fold"] += 1
    return work[:reduced_width(p, RLC_MAX_LANES)]
