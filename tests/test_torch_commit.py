"""The port's sign-bytes and commit-verification entry points against the
JAX package's, on the same seeded keys and commits: the bytes must be
identical, and every entry point must accept or reject (with the same
message) exactly as the JAX package does.  The port runs its plain
version (device="cpu"); the JAX side uses its CPU verifier."""

from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tendermint_tpu.crypto.batch import set_default_backend  # noqa: E402
from tendermint_tpu.crypto.keys import priv_key_from_seed as jax_key  # noqa: E402
from tendermint_tpu.types import basic as jbasic  # noqa: E402
from tendermint_tpu.types import canonical as jcanonical  # noqa: E402
from tendermint_tpu.types import commit as jcommit  # noqa: E402
from tendermint_tpu.types import validator as jvalidator  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.crypto.keys import PrivKey  # noqa: E402
from tendermint_tpu_torch.types import basic as tbasic  # noqa: E402
from tendermint_tpu_torch.types import canonical as tcanonical  # noqa: E402
from tendermint_tpu_torch.types import commit as tcommit  # noqa: E402
from tendermint_tpu_torch.types import validator as tvalidator  # noqa: E402

CHAIN = "port-chain"


@pytest.fixture(autouse=True)
def jax_cpu_backend():
    set_default_backend("cpu")
    yield
    set_default_backend("auto")


def _block_ids(mod, seed=b"blk"):
    return (mod.BlockID(),
            mod.BlockID(hash=bytes(range(32)),
                        part_set_header=mod.PartSetHeader(total=3, hash=seed * 10 + b"xy")))


def test_vote_sign_bytes_match_jax():
    timestamps = [jbasic.GO_ZERO_TIME_NS, 0, -1, 1, 1_700_000_000_123_456_789,
                  -62_000_000_000_999_999_999]
    for chain_id in ("", CHAIN):
        for msg_type in (0, 1, 2, 32):
            for height, round_ in ((0, 0), (1, 3), (2**62, 2**31 - 1)):
                for jbid, tbid in zip(_block_ids(jbasic), _block_ids(tbasic)):
                    for ts in timestamps:
                        want = jcanonical.vote_sign_bytes_raw(
                            chain_id, jbasic.SignedMsgType(msg_type), height, round_, jbid, ts)
                        got = tcanonical.vote_sign_bytes_raw(
                            chain_id, tbasic.SignedMsgType(msg_type), height, round_, tbid, ts)
                        assert got == want, (chain_id, msg_type, height, ts)


# ---------------------------------------------------------------------------
# Commits built in both packages from the same keys and signatures
# ---------------------------------------------------------------------------

def _seeds(n):
    rng = np.random.default_rng(42)
    return [rng.bytes(32) for _ in range(n)]


def _sets(n, power=10):
    """(JAX set, port set, port keys in set order); the port set comes
    from the numpy form of the JAX set's keys."""
    seeds = _seeds(n)
    jvals = jvalidator.ValidatorSet([
        jvalidator.Validator(pub_key=jax_key(s).pub_key(), voting_power=power) for s in seeds])
    pubs = np.stack([np.frombuffer(v.pub_key.bytes_(), dtype=np.uint8) for v in jvals.validators])
    tvals = convert.validator_set_from_numpy(pubs, np.full(n, power, dtype=np.int64))
    keys = {PrivKey(s).pub_key().bytes_(): PrivKey(s) for s in seeds}
    ordered = [keys[v.pub_key.bytes_()] for v in tvals.validators]
    assert [v.address for v in tvals.validators] == [v.address for v in jvals.validators]
    return jvals, tvals, ordered


def _commits(tvals, keys, height, absent=(), nil=(), zeroed=(), flipped=()):
    """(JAX commit, port commit) with the same signatures, signed by the
    port's keys over the port's sign-bytes."""
    _, bid = _block_ids(tbasic)
    tc = tcommit.Commit(height=height, round=0, block_id=bid)
    for i, val in enumerate(tvals.validators):
        if i in absent:
            tc.signatures.append(tcommit.CommitSig.absent_sig())
            continue
        flag = tbasic.BlockIDFlag.NIL if i in nil else tbasic.BlockIDFlag.COMMIT
        tc.signatures.append(tcommit.CommitSig(flag, val.address, 1_000_000_007 * (height + i)))
    for i, cs in enumerate(tc.signatures):
        if cs.absent():
            continue
        sig = keys[i].sign(tc.vote_sign_bytes(CHAIN, i))
        if i in zeroed:
            sig = bytes(64)
        if i in flipped:
            sig = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        cs.signature = sig
    _, jbid = _block_ids(jbasic)
    jc = jcommit.Commit(
        height=height, round=0, block_id=jbid,
        signatures=[jcommit.CommitSig(jbasic.BlockIDFlag(int(cs.block_id_flag)),
                                      cs.validator_address, cs.timestamp_ns, cs.signature)
                    for cs in tc.signatures])
    return jc, tc


def test_keys_and_commit_sign_bytes_match_jax():
    jvals, tvals, keys = _sets(6)
    for k in keys:
        jk = jax_key(k.bytes_()[:32])
        assert k.pub_key().bytes_() == jk.pub_key().bytes_()
        assert k.pub_key().address() == jk.pub_key().address()
        assert k.sign(b"vote") == jk.sign(b"vote")  # RFC 8032: deterministic
    jc, tc = _commits(tvals, keys, 9, absent={1}, nil={4})
    idxs = [0, 2, 3, 4, 5]
    assert tc.vote_sign_bytes_batch(CHAIN, idxs) == jc.vote_sign_bytes_batch(CHAIN, idxs)
    for i in idxs:
        assert tc.vote_sign_bytes(CHAIN, i) == jc.vote_sign_bytes(CHAIN, i)


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "ok"


# (n validators, commit options, {entry point: accepted?})
SCENARIOS = {
    "all_good": (7, {}, dict(full=True, light=True, trusting=True, batch=True)),
    # trusting stops at 1/3 of the power, before the bad row
    "bad_signature": (4, {"zeroed": {2}}, dict(full=False, light=False, trusting=True,
                                                batch=False)),
    "flipped_bit_after_cutoff": (4, {"flipped": {3}}, dict(full=False, light=True, trusting=True,
                                                          batch=False)),
    "insufficient_power": (7, {"absent": {0, 1, 2, 3}}, dict(full=False, light=False,
                                                            trusting=True, batch=False)),
    "nil_votes": (4, {"nil": {3}}, dict(full=True, light=True, trusting=True, batch=True)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_commit_verification_matches_jax(name):
    n, opts, expected = SCENARIOS[name]
    jvals, tvals, keys = _sets(n)
    height = 10
    jc, tc = _commits(tvals, keys, height, **opts)
    _, jbid = _block_ids(jbasic)
    _, tbid = _block_ids(tbasic)
    trust = Fraction(1, 3)
    calls = {
        "full": (lambda: jvals.verify_commit(CHAIN, jbid, height, jc),
                 lambda: tvals.verify_commit(CHAIN, tbid, height, tc, device="cpu")),
        "light": (lambda: jvals.verify_commit_light(CHAIN, jbid, height, jc),
                  lambda: tvals.verify_commit_light(CHAIN, tbid, height, tc, device="cpu")),
        "trusting": (lambda: jvals.verify_commit_light_trusting(CHAIN, jc, trust),
                     lambda: tvals.verify_commit_light_trusting(CHAIN, tc, trust, device="cpu")),
        # one batch: the commit under both modes
        "batch": (lambda: jvalidator.batch_verify_commits([
                      jvalidator.CommitVerifyJob(jvals, CHAIN, jbid, height, jc, mode="light"),
                      jvalidator.CommitVerifyJob(jvals, CHAIN, jbid, height, jc, mode="full")]),
                  lambda: tvalidator.batch_verify_commits([
                      tvalidator.CommitVerifyJob(tvals, CHAIN, tbid, height, tc, mode="light"),
                      tvalidator.CommitVerifyJob(tvals, CHAIN, tbid, height, tc, mode="full")],
                      device="cpu")),
    }
    for entry, (jax_call, port_call) in calls.items():
        want = _outcome(jax_call)
        assert _outcome(port_call) == want, (name, entry)
        assert (want == "ok") == expected[entry], (name, entry, want)


def test_commit_basics_rejected_before_verification():
    jvals, tvals, keys = _sets(4)
    jc, tc = _commits(tvals, keys, 5)
    jbid0, jbid = _block_ids(jbasic)
    tbid0, tbid = _block_ids(tbasic)
    cases = [
        (lambda: jvals.verify_commit(CHAIN, jbid, 6, jc),
         lambda: tvals.verify_commit(CHAIN, tbid, 6, tc, device="cpu")),
        (lambda: jvals.verify_commit(CHAIN, jbid0, 5, jc),
         lambda: tvals.verify_commit(CHAIN, tbid0, 5, tc, device="cpu")),
        (lambda: jvals.verify_commit_light(CHAIN, jbid, 5, None),
         lambda: tvals.verify_commit_light(CHAIN, tbid, 5, None, device="cpu")),
    ]
    for jax_call, port_call in cases:
        want = _outcome(jax_call)
        assert want != "ok"
        assert _outcome(port_call) == want
