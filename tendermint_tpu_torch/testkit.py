"""Seeded inputs for the port's tests and ``chip_smoke.py``: the adversarial
signature gauntlet, edge-case field elements and point encodings, and
signed commits for validator sets of any size.

Everything is made from a seed with numpy, so two runs (and the JAX
package, handed the same bytes) see the same inputs.
"""

from __future__ import annotations

import numpy as np

from .crypto import ed25519 as ref
from .crypto.keys import PrivKey
from .ops import ed25519_torch
from .types.basic import BlockID, BlockIDFlag, PartSetHeader
from .types.commit import Commit, CommitSig
from .types.validator import Validator, ValidatorSet

# RFC 8032 section 7.1, test 1: (seed, public key, message, signature)
RFC8032_VECTOR_1 = (
    bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"),
    bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"),
    b"",
    bytes.fromhex(
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
)


def _seeded_keys(rng: np.random.Generator, n: int) -> list[PrivKey]:
    return [PrivKey(rng.bytes(32)) for _ in range(n)]


def _mixed_order_signature(rng: np.random.Generator, msg: bytes) -> tuple[bytes, bytes]:
    """(pub, sig) for a public key A' = [a]B + T8 with T8 of order 8 and an
    honest signature over it: valid under the cofactored ZIP-215 equation,
    invalid under a cofactorless one (k*T8 != O for most k)."""
    t8 = next(p for p in ref.eight_torsion_points()
              if not ref.pt_equal(ref.scalar_mult(4, p), ref.IDENTITY))
    a = int.from_bytes(rng.bytes(32), "little") % ref.L
    pub = ref.encode_point(ref.pt_add(ref.scalar_mult_base(a), t8))
    r = int.from_bytes(rng.bytes(32), "little") % ref.L
    big_r = ref.encode_point(ref.scalar_mult_base(r))
    s = (r + ref.compute_k(big_r, pub, msg) * a) % ref.L
    return pub, big_r + s.to_bytes(32, "little")


def adversarial_cases(seed: int = 0) -> list[tuple[bytes, bytes, bytes]]:
    """(pub, msg, sig) triples covering honest, tampered and adversarial
    inputs: the gauntlet of the JAX package's verifier tests, with every
    8-torsion point's encodings, s == L, a mixed-order key and RFC 8032
    test 1 added.  36 rows, both verdicts present."""
    rng = np.random.default_rng(seed)
    cases = []
    for i, k in enumerate(_seeded_keys(rng, 6)):
        msg = f"height={i}".encode()
        cases.append((k.pub_key().bytes_(), msg, k.sign(msg)))
    pub, msg, sig = cases[0]
    cases.append((pub, msg, sig[:-1] + bytes([sig[-1] ^ 1])))  # tampered signature
    cases.append((pub, b"other", sig))  # wrong message
    s = int.from_bytes(sig[32:], "little") + ref.L  # non-canonical s (s + L)
    cases.append((pub, msg, sig[:32] + s.to_bytes(32, "little")))
    cases.append((pub, msg, sig[:32] + (ref.L + 12345).to_bytes(32, "little")))  # s > L
    cases.append((pub, msg, sig[:32] + ref.L.to_bytes(32, "little")))  # s == L
    cases.append(((2).to_bytes(32, "little"), msg, sig))  # off-curve A (y = 2)
    cases.append((pub, msg, (2).to_bytes(32, "little") + sig[32:]))  # off-curve R
    # small-order A and R with s = 0: valid under cofactored ZIP-215,
    # every encoding ZIP-215 accepts (y >= p, x = 0 with sign 1)
    for pt in ref.eight_torsion_points():
        for enc in ref.noncanonical_encodings(pt):
            cases.append((enc, b"any", enc + bytes(32)))
    cases.append((ref.encode_point(ref.IDENTITY), msg, sig))  # identity pubkey
    mixed_pub, mixed_sig = _mixed_order_signature(rng, b"mixed")
    cases.append((mixed_pub, b"mixed", mixed_sig))
    cases.append((pub[:31], msg, sig))  # malformed lengths
    cases.append((pub, msg, sig[:63]))
    for _ in range(4):  # random garbage
        cases.append((rng.bytes(32), rng.bytes(8), rng.bytes(64)))
    _seed, rfc_pub, rfc_msg, rfc_sig = RFC8032_VECTOR_1
    cases.append((rfc_pub, rfc_msg, rfc_sig))
    return cases


def mixed_batch(pubs, msgs, sigs, seed: int = 0):
    """Valid (pub, msg, sig) rows with adversarial ones spread through
    them, and the verdict each row must get: of every 8 rows, two are
    gauntlet rows (``adversarial_cases``, tiled), one has a bit of R
    flipped, one a changed message (both must fail) and four stay as
    given (all must pass).  Every block of 8 rows, so every block of
    threads on the card, holds both verdicts.
    Returns (pubs, msgs, sigs, expected verdicts)."""
    cases = adversarial_cases(seed)
    case_ok = [ref.verify(*c) for c in cases]
    rng = np.random.default_rng(seed)
    out = ([], [], [], [])
    n_case = 0
    for i, (pub, msg, sig) in enumerate(zip(pubs, msgs, sigs)):
        slot, ok = i % 8, True
        if slot in (0, 3):
            pub, msg, sig = cases[n_case % len(cases)]
            ok = case_ok[n_case % len(cases)]
            n_case += 1
        elif slot == 5:
            byte, bit = int(rng.integers(0, 32)), 1 << int(rng.integers(0, 8))
            sig = sig[:byte] + bytes([sig[byte] ^ bit]) + sig[byte + 1:]
            ok = False
        elif slot == 6:
            msg, ok = msg + b"\x00", False
        for column, value in zip(out, (pub, msg, sig, ok)):
            column.append(value)
    return out


def field_edge_values() -> list[int]:
    """255-bit values at the edges of the field: 0, 1, p-1, p, p+1,
    2^255-1 and 2^255-19+small."""
    p = ref.P
    return [0, 1, 2, p - 1, p, p + 1, p + 18, (1 << 255) - 1, (1 << 255) - 2,
            (1 << 255) - 19 + 5, (1 << 255) - 20, 1 << 254, (1 << 51) - 1, 1 << 51]


def layout_edge_values() -> list[int]:
    """255-bit values whose limbs sit at the packed and f32 layouts'
    bounds: every even or every odd packed limb (26 / 25 bits) full, every
    even or odd 5-bit f32 limb full, each limb width's top bit alone, and
    p's neighbours in those limbs."""
    weights = [(51 * i + 1) // 2 for i in range(10)]
    widths = [26 - i % 2 for i in range(10)]
    packed = [sum(((1 << widths[i]) - 1) << weights[i] for i in range(parity, 10, 2))
              for parity in (0, 1)]
    f32 = [sum(31 << (5 * i) for i in range(parity, 51, 2)) for parity in (0, 1)]
    tops = [sum(1 << (weights[i] + widths[i] - 1) for i in range(10)),
            sum(16 << (5 * i) for i in range(51))]
    p = ref.P
    return packed + f32 + tops + [p - (1 << 26), p - (1 << 25), p - 32, p - 20]


def layout_edge_rows() -> np.ndarray:
    """``layout_edge_values`` as uint8 [*, 32] rows."""
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
                     for v in layout_edge_values()])


def field_rows(seed: int, n_random: int) -> np.ndarray:
    """uint8 [n_random + len(edges), 32]: random 255-bit values, then the
    edge values."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, size=(n_random, 32), dtype=np.uint8)
    rows[:, 31] &= 0x7F
    edges = np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
                      for v in field_edge_values()])
    return np.concatenate([rows, edges])


def decompress_rows(seed: int, n_random: int) -> np.ndarray:
    """uint8 [*, 32] point encodings: every 8-torsion point's ZIP-215
    encodings (canonical, y >= p, x = 0 with sign 1), y = 2 (off the
    curve) with both signs, and random y with a random sign bit."""
    encs = [e for pt in ref.eight_torsion_points() for e in ref.noncanonical_encodings(pt)]
    encs += [(2).to_bytes(32, "little"), ((2) | (1 << 255)).to_bytes(32, "little")]
    encs += [ref.encode_point(ref.BASE)]
    rows = np.stack([np.frombuffer(e, dtype=np.uint8) for e in encs])
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 256, size=(n_random, 32), dtype=np.uint8)
    return np.concatenate([rows, rand])


# ---------------------------------------------------------------------------
# RLC inputs
# ---------------------------------------------------------------------------

def rlc_rows(prepared, seed: int):
    """From ``prepare_batch``'s rows (pub, r, s, k, valid), the RLC
    equation's inputs with z made from a seed (the port's own
    ``prepare_rlc_scalars`` draws z from ``os.urandom``) under the same
    rules: a z of zero becomes 1, rows with valid False get z = 0.
    Returns ((pub, r, zk, z, valid), numpy, and c_row, uint8 [32])."""
    pub_rows, r_rows, s_rows, k_rows, valid = prepared
    z_rows = np.random.default_rng(seed).integers(0, 256, size=(len(valid), 16), dtype=np.uint8)
    z_rows[~z_rows.any(axis=1), 0] = 1
    z_rows[~valid] = 0
    zk_rows, c_row = ed25519_torch.rlc_scalars(z_rows, s_rows, k_rows)
    return (pub_rows, r_rows, zk_rows, z_rows, valid), c_row


# ---------------------------------------------------------------------------
# Signed commits
# ---------------------------------------------------------------------------

CHAIN_ID = "test-chain"
BASE_TIME_NS = 1_700_000_000_000_000_000


def validator_keys(seed: int, n: int) -> list[PrivKey]:
    return _seeded_keys(np.random.default_rng(seed), n)


def validator_set(keys: list[PrivKey], power: int = 10) -> ValidatorSet:
    return ValidatorSet([Validator(k.pub_key(), power) for k in keys])


def block_id_for(height: int) -> BlockID:
    h = height.to_bytes(8, "little")
    return BlockID(hash=(h * 4), part_set_header=PartSetHeader(total=1, hash=h[::-1] * 4))


def signed_commit(keys: list[PrivKey], vals: ValidatorSet, height: int,
                  absent: tuple[int, ...] = ()) -> Commit:
    """A commit for `block_id_for(height)` in which every validator of
    `vals` (by index) except those in `absent` signed its precommit."""
    by_address = {k.pub_key().address(): k for k in keys}
    commit = Commit(height=height, round=0, block_id=block_id_for(height))
    for idx, val in enumerate(vals.validators):
        if idx in absent:
            commit.signatures.append(CommitSig.absent_sig())
        else:
            commit.signatures.append(CommitSig(BlockIDFlag.COMMIT, val.address,
                                               BASE_TIME_NS + height * 1_000 + idx))
    for idx, cs in enumerate(commit.signatures):
        if not cs.absent():
            cs.signature = by_address[cs.validator_address].sign(
                commit.vote_sign_bytes(CHAIN_ID, idx))
    return commit
