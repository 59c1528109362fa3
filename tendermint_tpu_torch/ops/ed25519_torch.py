"""Batched ZIP-215 Ed25519 verification: host prep, the plain PyTorch
verify pipeline, and dispatch to the verify CUDA kernels.

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

Field layouts (``impl``, as in the JAX package): "int64" (kernel
``ed25519_verify``, 5 x 51-bit limbs; plain version in the 15 x 17-bit
limbs of ``ops/fe25519.py``), "packed" (``ed25519_verify_packed``, 10 x
25.5-bit limbs, ``ops/fe25519_packed.py``) and "f32"
(``ed25519_verify_f32``, 51 signed 5-bit float limbs,
``ops/fe25519_f32.py``).  With the comb (``base_mxu``, int64 and f32
only) [s]B is a w=8 comb whose per-window selection is a one-hot x table
product on the tensor cores (kernels ``ed25519_verify_comb`` and
``ed25519_verify_f32_comb``).  ``verify_batch`` picks the layout per call
(``TM_CUDA_FIELD_IMPL``, default ``auto``) and the comb
(``TM_CUDA_BASE_MXU``) behind the golden-batch gate below.  On a CUDA
tensor ``verify_rows`` launches the kernel; on a CPU tensor it runs
``verify_core``, the plain version.  The kernels take any N, so there is
no bucket ladder.

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
import warnings

import numpy as np
import torch

from .. import knobs
from ..crypto import ed25519 as _ref
from ..crypto.keys import PrivKey
from . import fe25519 as fe
from . import fe25519_f32, fe25519_packed, kernels

L = _ref.L
NWINDOWS = _ref.NWINDOWS

IMPLS = ("int64", "f32", "packed")
_FIELDS = {"int64": fe, "packed": fe25519_packed, "f32": fe25519_f32}


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

def _nibbles_of(rows: torch.Tensor) -> torch.Tensor:
    """[..., B] uint8 -> [..., 2B] little-endian radix-16 digits."""
    lo = (rows & 15).to(torch.int64)
    hi = (rows >> 4).to(torch.int64)
    return torch.stack([lo, hi], dim=-1).reshape(rows.shape[:-1] + (2 * rows.shape[-1],))


# ---------------------------------------------------------------------------
# Curve pipeline (plain version), one per field layout
# ---------------------------------------------------------------------------

def _select16(digit: torch.Tensor, tbl: list):
    """tbl[digit] per batch element.  Every input is public, so a gather
    stands in for the JAX module's constant-time select tree."""
    rows = torch.arange(digit.shape[0], device=digit.device)
    coords = zip(*(p.astuple() for p in tbl))
    return fe.Pt(*(torch.stack(torch.broadcast_tensors(*c))[digit, rows] for c in coords))


class _Core:
    """The verify pipeline on one field layout (``fe``: ``ops/fe25519``,
    ``ops/fe25519_packed`` or ``ops/fe25519_f32``), the counterpart of
    the JAX package's ``_Core(fe)``."""

    def __init__(self, impl: str):
        self.impl = impl
        self.fe = _FIELDS[impl]

    def decompress(self, y: torch.Tensor, sign: torch.Tensor):
        """Permissive (ZIP-215) decompression.

        y: [..., NLIMBS] limbs of the 255-bit y encoding (possibly >= p);
        sign: [...] in {0, 1}.  Returns (point, on_curve).  x = 0 with
        sign 1 is accepted and stays 0; the sign flip is taken on the
        canonical x."""
        f = self.fe
        one = f.const("ONE", y.device)
        yy = f.fe_sq(y)
        u = f.fe_sub(yy, one)
        v = f.fe_carry(f.fe_add(f.fe_mul(yy, f.const("D", y.device)), one))
        v2 = f.fe_sq(v)
        v3 = f.fe_mul(v2, v)
        v7 = f.fe_mul(f.fe_sq(v3), v)
        t = f.fe_pow_p58(f.fe_mul(u, v7))
        x = f.fe_mul(f.fe_mul(u, v3), t)  # candidate sqrt(u/v)
        vx2 = f.fe_mul(v, f.fe_sq(x))
        is_pos = f.fe_eq(vx2, u)
        is_neg = f.fe_eq(vx2, f.fe_carry(f.fe_neg(f.fe_canonical(u))))
        ok = is_pos | is_neg
        x = torch.where(is_neg[..., None], f.fe_mul(x, f.const("SQRT_M1", y.device)), x)
        cx = f.fe_canonical(x)
        flip = (cx[..., 0].to(torch.int64) & 1) != sign
        x = torch.where(flip[..., None], f.fe_carry(f.fe_neg(cx)), cx)
        yr = f.fe_canonical(y)
        return fe.Pt(x, yr, one.expand(yr.shape), f.fe_mul(x, yr)), ok

    def decompress_rows(self, rows: torch.Tensor):
        """decompress() of 32-byte encodings, uint8 [..., 32]."""
        bits = fe.bits_of(rows)
        return self.decompress(self.fe.limbs_of_bits(bits[..., :255]), bits[..., 255])

    def scalarmul_var(self, digits: torch.Tensor, neg_a) -> fe.Pt:
        """[k](-A) by 4-bit fixed windows: a 16-entry per-signature table
        (14 adds to build), then 63 iterations of 4 doublings + 1 add."""
        f = self.fe
        tbl = [f.pt_identity(digits.shape[:-1], digits.device), neg_a]
        for _ in range(14):
            tbl.append(f.pt_add(tbl[-1], neg_a))
        acc = _select16(digits[..., NWINDOWS - 1], tbl)
        for i in range(1, NWINDOWS):
            acc = f.pt_dbl_n(acc, 4)
            acc = f.pt_add(acc, _select16(digits[..., NWINDOWS - 1 - i], tbl))
        return acc

    def scalarmul_base(self, digits: torch.Tensor) -> fe.Pt:
        """[s]B from the radix-16 fixed-base tables: 63 additions."""
        tx, ty, tz, tt = _fixed_base_tables(digits.device, self.impl)

        def entry(i):
            d = digits[..., i]
            return fe.Pt(tx[i][d], ty[i][d], tz[i][d], tt[i][d])

        acc = entry(0)
        for i in range(1, NWINDOWS):
            acc = self.fe.pt_add(acc, entry(i))
        return acc

    def scalarmul_base_mxu(self, s_rows: torch.Tensor) -> fe.Pt:
        """[s]B by the w=8 comb, the plain version of the kernels' tensor-
        core selection: the 32 s bytes are radix-256 digits, each window's
        entry is the one-hot x table product of ``comb_select_plain`` on
        the kernels' own byte table, unpacked to this layout's limbs; 31
        additions."""
        sel = comb_select_plain(s_rows, kernels.comb_table(s_rows.device))
        limbs = self.fe.fe_from_bytes(sel.reshape(s_rows.shape[0], 32, 4, 32))
        acc = fe.Pt(*limbs[:, 0].unbind(1))
        for i in range(1, 32):
            acc = self.fe.pt_add(acc, fe.Pt(*limbs[:, i].unbind(1)))
        return acc

    @torch.inference_mode()
    def verify_core(self, pub_rows, r_rows, s_rows, k_rows, valid, base_mxu=False):
        """Plain version of the verify kernels.  Inputs are packed rows
        (uint8 [N, 32] each) and valid (bool [N]); returns bool [N].  Its
        thousands of small ops run without autograd bookkeeping."""
        f = self.fe
        a_pt, ok_a = self.decompress_rows(pub_rows)
        r_pt, ok_r = self.decompress_rows(r_rows)
        sb = self.scalarmul_base_mxu(s_rows) if base_mxu else self.scalarmul_base(
            _nibbles_of(s_rows))
        w = f.pt_add(sb, self.scalarmul_var(_nibbles_of(k_rows), f.pt_neg(a_pt)))
        q = f.pt_add(w, f.pt_neg(r_pt))
        q8 = f.pt_dbl_n(q, 3)
        return valid & ok_a & ok_r & f.pt_is_identity(q8)


@functools.cache
def _core(impl: str) -> _Core:
    if impl not in IMPLS:
        raise ValueError(f"unknown field impl {impl!r}; expected one of {IMPLS}")
    return _Core(impl)


@functools.cache
def _fixed_base_tables(device: torch.device, impl: str = "int64") -> tuple[torch.Tensor, ...]:
    """The radix-16 base-point table as four [64, 16, NLIMBS] limb tensors
    (X, Y, Z, T) of `impl`'s layout on `device`: the layout of the JAX
    package's ``_Core(fe)._fixed_base_tables``."""
    f = _FIELDS[impl]
    coords = [np.zeros((NWINDOWS, 16, f.NLIMBS), dtype=np.asarray(f.limbs_from_int(0)).dtype)
              for _ in range(4)]
    for i, row in enumerate(_ref.base_point_table()):
        for j, pt in enumerate(row):
            for c in range(4):
                coords[c][i, j] = f.limbs_from_int(pt[c])
    return tuple(torch.as_tensor(c, device=device) for c in coords)


def verify_core(pub_rows, r_rows, s_rows, k_rows, valid, impl="int64", base_mxu=False):
    """Plain version of the verify kernel of `impl` (and of its comb
    variant with `base_mxu`); bool [N]."""
    return _core(impl).verify_core(pub_rows, r_rows, s_rows, k_rows, valid, base_mxu)


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
    a_pt, ok_a = _core("int64").decompress_rows(pub_rows)
    r_pt, ok_r = _core("int64").decompress_rows(r_rows)
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
    pt, ok = _core("int64").decompress_rows(enc)
    return torch.stack([fe.fe_to_bytes(pt.x), fe.fe_to_bytes(pt.y)], dim=-2), ok


# ---------------------------------------------------------------------------
# Dispatch: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def kernel_table(impl: str, base_mxu: bool, device: torch.device) -> torch.Tensor:
    """The table the verify kernel of (`impl`, `base_mxu`) reads, on
    `device`: the comb's bytes, the 5 x 51-bit table of ``ed25519_verify``,
    or the plain version's own limb tables (the packed and f32 kernels
    keep the JAX layouts) as one [64, 16, 4, NLIMBS] tensor."""
    if base_mxu:
        return kernels.comb_table(device)
    if impl == "int64":
        return kernels.base_table(device)
    return _limb_table(device, impl)


@functools.cache
def _limb_table(device: torch.device, impl: str) -> torch.Tensor:
    dtype = torch.int32 if impl == "packed" else torch.float32  # packed limbs < 2^26
    return torch.stack(_fixed_base_tables(device, impl), dim=2).to(dtype).contiguous()


def verify_rows(pub_rows, r_rows, s_rows, k_rows, valid, impl="int64",
                base_mxu=False) -> torch.Tensor:
    """bool [N] verdicts for packed rows in the field layout `impl`, with
    [s]B by the comb where `base_mxu`: the verify kernel of that pair for
    CUDA tensors, ``verify_core`` for CPU tensors.  The comb is never
    offered for packed, as in the JAX package."""
    if base_mxu and impl == "packed":
        raise ValueError("the comb ([s]B by TM_CUDA_BASE_MXU) is not offered for packed")
    if pub_rows.is_cuda:
        return kernels.verify(impl, base_mxu)(pub_rows, r_rows, s_rows, k_rows, valid,
                                              kernel_table(impl, base_mxu, pub_rows.device))
    return verify_core(pub_rows, r_rows, s_rows, k_rows, valid, impl, base_mxu)


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


def comb_select_plain(s_rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``comb_select`` kernel: per window w, the
    one-hot [N, 256] x byte table [256, 128] product (float64, exact),
    uint8 [N, 32, 128]."""
    cols = table.to(torch.float64)
    out = [torch.matmul(torch.nn.functional.one_hot(s_rows[:, w].to(torch.int64), 256)
                        .to(torch.float64), cols[w].T) for w in range(32)]
    return torch.stack(out, dim=1).to(torch.uint8)


def comb_select_rows(s_rows: torch.Tensor) -> torch.Tensor:
    """The ``comb_select`` kernel for a CUDA tensor, its plain version for a
    CPU tensor, on the comb table of that device."""
    table = kernels.comb_table(s_rows.device)
    if s_rows.is_cuda:
        return kernels.comb_select(s_rows, table)
    return comb_select_plain(s_rows, table)


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


# ---------------------------------------------------------------------------
# The field layout and the comb, chosen per call behind a golden-batch gate
# ---------------------------------------------------------------------------
#
# Counterpart of the JAX package's default_impl / _resolve_auto_impl and
# _optin_safe / _resolve_optin.  A layout or the comb is trusted on a
# device only once it reproduces the golden batch's known verdicts there.
# TM_CUDA_FIELD_IMPL and TM_CUDA_BASE_MXU are read at every call.

OPTIN_STATE: dict[tuple[str, str, str], bool] = {}  # (flag, impl, device type) -> passed


def default_impl(device=None) -> str:
    """The field layout for a call on `device`: ``TM_CUDA_FIELD_IMPL`` as
    read now when it names one, else (``auto``, or anything else) the
    ladder of ``_resolve_auto_impl``."""
    impl = knobs.read("TM_CUDA_FIELD_IMPL")
    if impl in IMPLS:
        return impl
    return _resolve_auto_impl(resolve_device(device))


def _resolve_auto_impl(device: torch.device) -> str:
    """``auto``: int64 on the CPU, with no golden run.  On the card, the
    JAX package's ladder in its order: f32 where its matrix-unit fe_mul
    is available and gated (not ported yet, so never), else packed where
    the packed kernel passes the golden batch, else int64."""
    if device.type != "cuda":
        return "int64"
    if _optin_safe("impl", "packed", device):
        return "packed"
    return "int64"


def _golden_batch():
    """The JAX package's golden batch: 8 deterministic signatures, rows 3
    and 6 corrupted.  Returns (prepared rows, numpy; verdicts wanted)."""
    pubs, msgs, sigs, want = [], [], [], []
    for i in range(8):
        k = PrivKey(bytes([i + 41]) * 32)
        m = b"optin-golden-%d" % i
        s = k.sign(m)
        ok = True
        if i in (3, 6):
            s = s[:-1] + bytes([s[-1] ^ 1])
            ok = False
        pubs.append(k.pub_key().bytes_())
        msgs.append(m)
        sigs.append(s)
        want.append(ok)
    return prepare_batch(pubs, msgs, sigs), want


def _optin_safe(flag: str, impl: str, device: torch.device) -> bool:
    """True iff `impl`'s verify kernel (flag "impl") or its comb variant
    (flag "base_mxu") reproduces the golden verdicts on `device`.
    Memoised per (flag, impl, device type).  A wrong verdict or a launch
    error (the ``RuntimeError`` a wrapper or the CUDA runtime raises) warns
    and refuses; a kernel that fails to build raises here, before the
    check, and any other exception, a defect of the code, propagates, so
    no refusal hides either."""
    key = (flag, impl, device.type)
    if key in OPTIN_STATE:
        return OPTIN_STATE[key]
    if device.type == "cuda":
        kernels.library()
    rows, want = _golden_batch()
    try:
        got = verify_rows(*rows_to_device(rows, device), impl=impl,
                          base_mxu=flag == "base_mxu")
        ok = got.cpu().tolist() == want
    except RuntimeError as e:  # a launch error is a refusal too
        warnings.warn(f"opt-in kernel {flag!r} ({impl}) failed its golden self-check "
                      f"with an error; disabled: {e}")
        ok = False
    if not ok:
        warnings.warn(f"opt-in kernel {flag!r} ({impl}) computed WRONG verdicts on "
                      f"{device.type} (golden-batch self-check); the standard kernel "
                      "is used instead")
    OPTIN_STATE[key] = ok
    return ok


def _resolve_optin(impl: str, device: torch.device) -> bool:
    """Whether this call takes the comb: ``TM_CUDA_BASE_MXU=1`` as read
    now, never for packed (as in the JAX package), and only once the
    comb passed its golden batch on this device."""
    if knobs.read("TM_CUDA_BASE_MXU") != "1" or impl == "packed":
        return False
    return _optin_safe("base_mxu", impl, device)


def verify_batch(pubs, msgs, sigs, impl=None, device=None) -> np.ndarray:
    """ZIP-215 verification of the whole batch; bool [N] numpy.

    On ``cuda`` (the default) one launch of the verify kernel of the
    field layout `impl` (``default_impl()`` when None) covers the batch,
    through the comb where ``_resolve_optin`` grants it;
    ``device="cpu"`` runs the plain version."""
    dev = resolve_device(device)
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    impl = impl or default_impl(dev)
    base_mxu = _resolve_optin(impl, dev)
    rows = rows_to_device(prepare_batch(pubs, msgs, sigs), dev)
    return verify_rows(*rows, impl=impl, base_mxu=base_mxu).cpu().numpy()


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


def verify_batch_rlc(pubs, msgs, sigs, impl=None, device=None) -> np.ndarray:
    """ZIP-215 verification of the whole batch through the RLC equation;
    bool [N] numpy, the same verdicts as ``verify_batch``.

    One ``ed25519_rlc`` launch (and one ``rlc_fold`` above 8,192 rows)
    on ``cuda``, the plain version for ``device="cpu"``.  A batch that
    passes returns prevalid.  A batch that fails (it holds a bad row, or,
    with probability about 2^-125, z was unlucky) is decided by the exact
    per-row ``verify_rows`` on the rows already prepared, in the field
    layout `impl` (``default_impl()`` when None): the RLC kernels
    themselves keep 5 x 51-bit limbs whatever the layout."""
    dev = resolve_device(device)
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    impl = impl or default_impl(dev)
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
    return verify_rows(pub_d, r_d, s_d, k_d, valid_d, impl=impl,
                       base_mxu=_resolve_optin(impl, dev)).cpu().numpy()
