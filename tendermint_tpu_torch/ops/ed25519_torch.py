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
"""

from __future__ import annotations

import functools
import hashlib

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
