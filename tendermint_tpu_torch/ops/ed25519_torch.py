"""Batched ZIP-215 Ed25519 verification: host prep, the plain PyTorch
verify pipeline, and dispatch to the ``ed25519_verify`` CUDA kernel.

Counterpart of ``tendermint_tpu/ops/ed25519_jax.py`` (``_Core`` and
``prepare_batch``).  Pipeline per batch:
  host:   parse sig/pubkey bytes, check s < L (ZIP-215 rule 1), hash
          k = SHA-512(R||A||M) mod L over the raw R and A bytes as given;
          packed 32-byte rows, 128 B per signature.
  device: unpack bytes to limbs and digits, decompress A and R
          permissively (rule 2), W = [s]B + [k](-A) with radix-16
          fixed-base tables for B and a 4-bit window ladder for A,
          Q = W - R, and the cofactored check [8]Q == O (rule 3).

-[k]A is computed as [k](-A), never as [L-k]A: the two differ for points
with a torsion component, exactly the inputs ZIP-215 admits.

On a CUDA tensor, ``verify_rows`` launches the kernel; on a CPU tensor it
runs ``verify_core``, the plain version, in the 15 x 17-bit limbs of
``ops/fe25519.py``.  The kernel takes any N, so there is no bucket ladder.

The RLC path (``verify_batch_rlc``, counterpart of the JAX package's
function of that name) checks the whole batch with one cofactored
random-linear-combination equation: the ``ed25519_rlc`` and ``rlc_fold``
kernels (or ``verify_core_rlc``, their plain version) sum the rows'
terms into lanes, and the host finishes the equation in big-int
(``finalize_rlc``).  A batch that fails it is decided row by row by
``verify_rows`` on the rows already prepared, so the verdicts are always
the per-row ones.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from ..crypto import ed25519 as _ref
from . import fe25519 as fe
from . import kernels

L = _ref.L
NWINDOWS = _ref.NWINDOWS


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; with no CUDA
    device present that raises — nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain version")
    return dev


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------

def _bits_of(rows: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] bits (LE bit order)."""
    b = (rows[..., :, None].to(torch.int64) >> torch.arange(8, device=rows.device)) & 1
    return b.reshape(rows.shape[:-1] + (256,))


def _nibbles_of(rows: torch.Tensor) -> torch.Tensor:
    """[..., B] uint8 -> [..., 2B] little-endian radix-16 digits."""
    lo = (rows & 15).to(torch.int64)
    hi = (rows >> 4).to(torch.int64)
    return torch.stack([lo, hi], dim=-1).reshape(rows.shape[:-1] + (2 * rows.shape[-1],))


def _limbs_of(bits255: torch.Tensor) -> torch.Tensor:
    """[..., 255] bits -> [..., 15] limbs."""
    shaped = bits255.reshape(bits255.shape[:-1] + (fe.NLIMBS, fe.LIMB_BITS))
    w = torch.as_tensor(1 << np.arange(fe.LIMB_BITS, dtype=np.int64), device=bits255.device)
    return (shaped * w).sum(-1)


# ---------------------------------------------------------------------------
# Curve pipeline (plain version)
# ---------------------------------------------------------------------------

def decompress(y: torch.Tensor, sign: torch.Tensor):
    """Permissive (ZIP-215) decompression.

    y: [..., 15] limbs of the 255-bit y encoding (possibly >= p); sign:
    [...] in {0, 1}.  Returns (point, on_curve).  x = 0 with sign 1 is
    accepted and stays 0; the sign flip is taken on the canonical x."""
    one = fe.const("ONE", y.device)
    yy = fe.fe_sq(y)
    u = fe.fe_sub(yy, one)
    v = fe.fe_carry(fe.fe_add(fe.fe_mul(yy, fe.const("D", y.device)), one))
    v2 = fe.fe_sq(v)
    v3 = fe.fe_mul(v2, v)
    v7 = fe.fe_mul(fe.fe_sq(v3), v)
    t = fe.fe_pow_p58(fe.fe_mul(u, v7))
    x = fe.fe_mul(fe.fe_mul(u, v3), t)  # candidate sqrt(u/v)
    vx2 = fe.fe_mul(v, fe.fe_sq(x))
    is_pos = fe.fe_eq(vx2, u)
    is_neg = fe.fe_eq(vx2, fe.fe_carry(fe.fe_neg(fe.fe_canonical(u))))
    ok = is_pos | is_neg
    x = torch.where(is_neg[..., None], fe.fe_mul(x, fe.const("SQRT_M1", y.device)), x)
    cx = fe.fe_canonical(x)
    flip = (cx[..., 0] & 1) != sign
    x = torch.where(flip[..., None], fe.fe_carry(fe.fe_neg(cx)), cx)
    yr = fe.fe_canonical(y)
    return fe.Pt(x, yr, one.expand(yr.shape), fe.fe_mul(x, yr)), ok


def _select16(digit: torch.Tensor, tbl: list) -> fe.Pt:
    """tbl[digit] per batch element.  Every input is public, so a gather
    stands in for the JAX module's constant-time select tree."""
    rows = torch.arange(digit.shape[0], device=digit.device)
    coords = zip(*(p.astuple() for p in tbl))
    return fe.Pt(*(torch.stack(torch.broadcast_tensors(*c))[digit, rows] for c in coords))


def _scalarmul_var(digits: torch.Tensor, neg_a: fe.Pt) -> fe.Pt:
    """[k](-A) by 4-bit fixed windows: a 16-entry per-signature table
    (14 adds to build), then 63 iterations of 4 doublings + 1 add."""
    shape = digits.shape[:-1]
    tbl = [fe.pt_identity(shape, digits.device), neg_a]
    for _ in range(14):
        tbl.append(fe.pt_add(tbl[-1], neg_a))
    acc = _select16(digits[..., NWINDOWS - 1], tbl)
    for i in range(1, NWINDOWS):
        acc = fe.pt_dbl_n(acc, 4)
        acc = fe.pt_add(acc, _select16(digits[..., NWINDOWS - 1 - i], tbl))
    return acc


@functools.cache
def _fixed_base_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The base-point table as four [64, 16, 15] limb tensors (X, Y, Z, T)
    on `device` — the layout of ``_Core(fe25519)._fixed_base_tables``."""
    coords = [np.zeros((NWINDOWS, 16, fe.NLIMBS), dtype=np.int64) for _ in range(4)]
    for i, row in enumerate(_ref.base_point_table()):
        for j, pt in enumerate(row):
            for c in range(4):
                coords[c][i, j] = fe.limbs_from_int(pt[c])
    return tuple(torch.as_tensor(c, device=device) for c in coords)


def _scalarmul_base(digits: torch.Tensor) -> fe.Pt:
    """[s]B from the fixed-base tables: 63 additions, no doublings."""
    tx, ty, tz, tt = _fixed_base_tables(digits.device)

    def entry(i):
        d = digits[..., i]
        return fe.Pt(tx[i][d], ty[i][d], tz[i][d], tt[i][d])

    acc = entry(0)
    for i in range(1, NWINDOWS):
        acc = fe.pt_add(acc, entry(i))
    return acc


@torch.inference_mode()
def verify_core(pub_rows, r_rows, s_rows, k_rows, valid) -> torch.Tensor:
    """Plain version of the ``ed25519_verify`` kernel.  Inputs are packed
    rows (uint8 [N, 32] each) and valid (bool [N]); returns bool [N].
    Its thousands of small int64 ops run without autograd bookkeeping."""
    pub_bits = _bits_of(pub_rows)
    r_bits = _bits_of(r_rows)
    a_pt, ok_a = decompress(_limbs_of(pub_bits[..., :255]), pub_bits[..., 255])
    r_pt, ok_r = decompress(_limbs_of(r_bits[..., :255]), r_bits[..., 255])
    sb = _scalarmul_base(_nibbles_of(s_rows))
    w = fe.pt_add(sb, _scalarmul_var(_nibbles_of(k_rows), fe.pt_neg(a_pt)))
    q = fe.pt_add(w, fe.pt_neg(r_pt))
    q8 = fe.pt_dbl_n(q, 3)
    return valid & ok_a & ok_r & fe.pt_is_identity(q8)


# ---------------------------------------------------------------------------
# RLC batch equation (plain version)
# ---------------------------------------------------------------------------

REDUCE_LANES = 2048  # the JAX program's accumulator width (TM_TPU_RLC_LANES default)


def _table16(base: fe.Pt) -> list:
    """[O, P, 2P, ..., 15P] from a [N]-point (14 adds)."""
    tbl = [fe.pt_identity(base.x.shape[:-1], base.x.device), base]
    for _ in range(14):
        tbl.append(fe.pt_add(tbl[-1], base))
    return tbl


def _pt_reduce_to_lanes(p: fe.Pt, target: int) -> fe.Pt:
    """Fold a [N]-point to [kernels.reduced_width(N, target)] by pairwise
    addition, lane i + m into lane i; an odd last lane moves to m.  The
    same pairing as the JAX package's and as ``rlc_fold``."""
    n = p.x.shape[0]
    while n > target:
        m = n // 2
        s = fe.pt_add(fe.Pt(*(c[:m] for c in p.astuple())),
                      fe.Pt(*(c[m:2 * m] for c in p.astuple())))
        if n % 2:
            s = fe.Pt(*(torch.cat([a, c[2 * m:]]) for a, c in zip(s.astuple(), p.astuple())))
        p, n = s, m + n % 2
    return p


@torch.inference_mode()
def verify_core_rlc(pub_rows, r_rows, zk_rows, z_rows, valid, reduce_lanes=REDUCE_LANES):
    """Plain version of the ``ed25519_rlc`` + ``rlc_fold`` kernels, shaped
    as the JAX package's ``_Core.verify_core_rlc``:

        [8]( [c]B - sum_i [z_i k_i](A_i) - sum_i [z_i](R_i) ) == O

    Inputs: pub/r/zk rows uint8 [N, 32], z rows uint8 [N, 16] (the 128-bit
    z_i), valid bool [N].  Returns (lanes, prevalid): a [P]-point whose
    lanes sum to sum_i [z_i k_i](-A_i) + [z_i](-R_i), P =
    reduced_width(N, 128), the JAX program's lanes point for point; and
    prevalid = valid & A, R on the curve.  A row that is not prevalid
    selects digit 0, the identity, in every window.  The host finishes
    the equation (``finalize_rlc``)."""
    pub_bits = _bits_of(pub_rows)
    r_bits = _bits_of(r_rows)
    a_pt, ok_a = decompress(_limbs_of(pub_bits[..., :255]), pub_bits[..., 255])
    r_pt, ok_r = decompress(_limbs_of(r_bits[..., :255]), r_bits[..., 255])
    prevalid = valid & ok_a & ok_r
    zk_digits = torch.where(prevalid[..., None], _nibbles_of(zk_rows), 0)
    z_digits = torch.where(prevalid[..., None], _nibbles_of(z_rows), 0)
    tbl_a = _table16(fe.pt_neg(a_pt))
    tbl_r = _table16(fe.pt_neg(r_pt))
    lanes = kernels.reduced_width(pub_rows.shape[0], reduce_lanes)
    acc = fe.pt_identity((lanes,), pub_rows.device)
    # windows 63..32 take only the z*k digits; z has 32 digits
    for w in range(NWINDOWS - 1, -1, -1):
        sel = _select16(zk_digits[..., w], tbl_a)
        if w < 32:
            sel = fe.pt_add(sel, _select16(z_digits[..., w], tbl_r))
        acc = fe.pt_add(fe.pt_dbl_n(acc, 4), _pt_reduce_to_lanes(sel, reduce_lanes))
    return _pt_reduce_to_lanes(acc, kernels.RLC_MAX_LANES), prevalid


def lanes_to_pt(lanes: torch.Tensor) -> fe.Pt:
    """The kernels' lanes, int64 [P, 4, 5] of 51-bit limbs, as a [P]-point
    in the plain version's 15 x 17-bit limbs, on the same device."""
    parts = torch.stack([lanes & fe.MASK, (lanes >> 17) & fe.MASK, lanes >> 34], dim=-1)
    limbs = fe.fe_carry(parts.reshape(lanes.shape[:-1] + (fe.NLIMBS,)))
    return fe.Pt(*limbs.unbind(1))


def pt_rows(p: fe.Pt) -> torch.Tensor:
    """Canonical X, Y, Z, T of each lane as bytes, uint8 [P, 4, 32]."""
    return torch.stack([fe.fe_to_bytes(c) for c in p.astuple()], dim=1)


def decompress_rows_plain(enc: torch.Tensor):
    """Plain version of the ``decompress`` kernel: from encodings
    (uint8 [N, 32]) the canonical (x, y) as uint8 [N, 2, 32] and the
    on-curve flag bool [N]."""
    bits = _bits_of(enc)
    pt, ok = decompress(_limbs_of(bits[..., :255]), bits[..., 255])
    return torch.stack([fe.fe_to_bytes(pt.x), fe.fe_to_bytes(pt.y)], dim=-2), ok


# ---------------------------------------------------------------------------
# Dispatch: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def verify_rows(pub_rows, r_rows, s_rows, k_rows, valid) -> torch.Tensor:
    """bool [N] verdicts for packed rows: the ``ed25519_verify`` kernel for
    CUDA tensors, ``verify_core`` for CPU tensors."""
    if pub_rows.is_cuda:
        return kernels.ed25519_verify(pub_rows, r_rows, s_rows, k_rows, valid,
                                      kernels.base_table(pub_rows.device))
    return verify_core(pub_rows, r_rows, s_rows, k_rows, valid)


def verify_rows_rlc(pub_rows, r_rows, zk_rows, z_rows, valid):
    """(lanes, prevalid) of the RLC equation for packed rows: the
    ``ed25519_rlc`` kernel, then ``rlc_fold`` where it wrote more than 128
    lanes, for CUDA tensors; ``verify_core_rlc`` for CPU tensors.  Lanes
    come back as a point in the plain version's limbs."""
    if pub_rows.is_cuda:
        lanes, prevalid = kernels.ed25519_rlc(pub_rows, r_rows, zk_rows, z_rows, valid)
        if lanes.shape[0] > kernels.RLC_MAX_LANES:
            lanes = kernels.rlc_fold(lanes)
        return lanes_to_pt(lanes), prevalid
    return verify_core_rlc(pub_rows, r_rows, zk_rows, z_rows, valid)


def decompress_rows(enc: torch.Tensor):
    """The ``decompress`` kernel for a CUDA tensor, its plain version for a
    CPU tensor."""
    if enc.is_cuda:
        return kernels.decompress(enc)
    return decompress_rows_plain(enc)


# ---------------------------------------------------------------------------
# Host preprocessing
# ---------------------------------------------------------------------------

_L_WORDS = np.frombuffer(L.to_bytes(32, "little"), dtype="<u8").copy()


def prepare_batch(pubs, msgs, sigs):
    """Parse and validate on the host; returns packed inputs
    (pub_rows, r_rows, s_rows, k_rows, valid) — uint8 [N, 32] x 4 and
    bool [N], numpy.  Rows with a wrong length, or with s >= L, stay in
    the batch as zero rows with valid=False."""
    n = len(pubs)
    valid = np.ones(n, dtype=bool)

    well_formed = all(len(p) == 32 for p in pubs) and all(len(s) == 64 for s in sigs)
    if well_formed:
        pub_rows = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 32).copy()
        sig_rows = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
        r_rows = sig_rows[:, :32].copy()
        s_rows = sig_rows[:, 32:].copy()
    else:
        pub_rows = np.zeros((n, 32), dtype=np.uint8)
        r_rows = np.zeros((n, 32), dtype=np.uint8)
        s_rows = np.zeros((n, 32), dtype=np.uint8)
        for i, (pub, sig) in enumerate(zip(pubs, sigs)):
            if len(pub) != 32 or len(sig) != 64:
                valid[i] = False
                continue
            pub_rows[i] = np.frombuffer(pub, dtype=np.uint8)
            r_rows[i] = np.frombuffer(sig[:32], dtype=np.uint8)
            s_rows[i] = np.frombuffer(sig[32:], dtype=np.uint8)

    # ZIP-215 rule 1 (s < L): lexicographic compare on the four
    # little-endian 64-bit words, most significant first
    sw = s_rows.view("<u8")  # [n, 4]
    lt = np.zeros(n, dtype=bool)
    gt = np.zeros(n, dtype=bool)
    for w in (3, 2, 1, 0):
        lt = lt | (~gt & (sw[:, w] < _L_WORDS[w]))
        gt = gt | (~lt & (sw[:, w] > _L_WORDS[w]))
    valid &= lt  # s == L is also non-canonical

    # k = SHA-512(R || A || M) mod L over the raw bytes as given
    sha512 = hashlib.sha512
    from_bytes = int.from_bytes
    ks = bytearray(32 * n)
    for i in range(n):
        if not valid[i]:
            continue
        sig, pub = sigs[i], pubs[i]
        k = from_bytes(sha512(sig[:32] + pub + msgs[i]).digest(), "little") % L
        ks[32 * i : 32 * (i + 1)] = k.to_bytes(32, "little")
    k_rows = np.frombuffer(bytes(ks), dtype=np.uint8).reshape(n, 32).copy()
    return pub_rows, r_rows, s_rows, k_rows, valid


def rows_to_device(rows, device: torch.device):
    """The numpy rows of prepare_batch as tensors on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in rows)


def verify_batch(pubs, msgs, sigs, device=None) -> np.ndarray:
    """ZIP-215 verification of the whole batch; bool [N] numpy.

    On ``cuda`` (the default) one ``ed25519_verify`` launch covers the
    batch; ``device="cpu"`` runs the plain version."""
    dev = resolve_device(device)
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    rows = rows_to_device(prepare_batch(pubs, msgs, sigs), dev)
    return verify_rows(*rows).cpu().numpy()


# ---------------------------------------------------------------------------
# RLC batch verification (batch equation + exact per-row fallback)
# ---------------------------------------------------------------------------

RLC_STATS = {"pass": 0, "fallback": 0}


def rlc_scalars(z_rows, s_rows, k_rows):
    """zk_i = z_i k_i mod L (uint8 [N, 32]) and c = sum_i z_i s_i mod L
    (uint8 [32]), in Python big-int; rows with z_i = 0 add nothing."""
    n = len(z_rows)
    zk_rows = np.zeros((n, 32), dtype=np.uint8)
    c = 0
    for i in np.flatnonzero(z_rows.any(axis=1)):
        z = int.from_bytes(z_rows[i].tobytes(), "little")
        k = int.from_bytes(k_rows[i].tobytes(), "little")
        s = int.from_bytes(s_rows[i].tobytes(), "little")
        zk_rows[i] = np.frombuffer((z * k % L).to_bytes(32, "little"), dtype=np.uint8)
        c = (c + z * s) % L
    return zk_rows, np.frombuffer(c.to_bytes(32, "little"), dtype=np.uint8).copy()


def prepare_rlc_scalars(s_rows, k_rows, valid):
    """Sample z_i and compute the RLC scalars on the host: returns
    (z_rows uint8 [N, 16], zk_rows uint8 [N, 32], c_row uint8 [32]).

    z_i is 128 bits from ``os.urandom``: the equation is sound only if
    z cannot be predicted, so it never comes from a seeded generator.  A
    z_i of zero becomes 1; rows with valid False get z_i = 0 and drop out
    of every term."""
    n = len(valid)
    z_rows = np.frombuffer(os.urandom(16 * n), dtype=np.uint8).reshape(n, 16).copy()
    z_rows[~z_rows.any(axis=1), 0] = 1
    z_rows[~valid] = 0
    return (z_rows, *rlc_scalars(z_rows, s_rows, k_rows))


def finalize_rlc(lanes: fe.Pt, c_row) -> bool:
    """The host's finish of the RLC equation, in exact big-int: sum the
    lanes (any number), add [c]B, and test [8] * total == O.  The [8]
    comes after [c]B: only then do torsion components cancel."""
    coords = [c.cpu().numpy() for c in lanes.astuple()]
    total = _ref.IDENTITY
    for lane in range(coords[0].shape[0]):
        total = _ref.pt_add(total, tuple(fe.int_from_limbs(c[lane]) % _ref.P for c in coords))
    total = _ref.pt_add(total, _ref.scalar_mult_base(int.from_bytes(bytes(c_row), "little")))
    return _ref.pt_equal(_ref.scalar_mult(8, total), _ref.IDENTITY)


def verify_batch_rlc(pubs, msgs, sigs, device=None) -> np.ndarray:
    """ZIP-215 verification of the whole batch through the RLC equation;
    bool [N] numpy, the same verdicts as ``verify_batch``.

    One ``ed25519_rlc`` launch (and one ``rlc_fold`` above 8,192 rows)
    on ``cuda``, the plain version for ``device="cpu"``.  A batch that
    passes returns prevalid.  A batch that fails (it holds a bad row, or,
    with probability about 2^-125, z was unlucky) is decided by the exact
    per-row ``verify_rows`` on the rows already prepared."""
    dev = resolve_device(device)
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    pub_rows, r_rows, s_rows, k_rows, valid = prepare_batch(pubs, msgs, sigs)
    z_rows, zk_rows, c_row = prepare_rlc_scalars(s_rows, k_rows, valid)
    pub_d, r_d, zk_d, z_d, valid_d = rows_to_device(
        (pub_rows, r_rows, zk_rows, z_rows, valid), dev)
    lanes, prevalid = verify_rows_rlc(pub_d, r_d, zk_d, z_d, valid_d)
    if finalize_rlc(lanes, c_row):
        RLC_STATS["pass"] += 1
        return prevalid.cpu().numpy()
    RLC_STATS["fallback"] += 1
    s_d, k_d = rows_to_device((s_rows, k_rows), dev)
    return verify_rows(pub_d, r_d, s_d, k_d, valid_d).cpu().numpy()
