"""Validator and ValidatorSet, trimmed to commit verification.

Counterpart of ``tendermint_tpu/types/validator.py`` (reference
types/validator_set.go VerifyCommit :662, VerifyCommitLight :720,
VerifyCommitLightTrusting :776).  Each entry point collects the
commit's signatures into ONE batch verifier call — one kernel launch on
the card, in the field layout ``TM_CUDA_FIELD_IMPL`` selects at that
call — and keeps the reference's accept/reject semantics, including
the in-order early exit of the light variants (a bad signature after
the +2/3 cutoff is never consulted).  Every entry point takes
``device``: None runs on ``cuda``, ``"cpu"`` runs the plain version.
Proposer priority and change sets are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from ..crypto.batch import TorchBatchVerifier
from ..crypto.keys import PubKey
from .basic import BlockID

MAX_TOTAL_VOTING_POWER = (1 << 63) - 1 >> 3  # reference: MaxTotalVotingPower int64/8


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = b""

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()


def _sort_by_voting_power(vals: list[Validator]) -> list[Validator]:
    return sorted(vals, key=lambda v: (-v.voting_power, v.address))


class ValidatorSet:
    """Validators sorted by (voting power desc, address asc), the order
    a commit's signatures follow (reference validator_set.go:904-918)."""

    def __init__(self, validators: list[Validator]):
        self.validators = _sort_by_voting_power(
            [Validator(v.pub_key, v.voting_power, v.address) for v in validators])
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power exceeds maximum")
        self._total_voting_power = total
        self._by_address = {v.address: i for i, v in enumerate(self.validators)}

    def total_voting_power(self) -> int:
        return self._total_voting_power

    def size(self) -> int:
        return len(self.validators)

    def get_by_address(self, address: bytes) -> tuple[int, Validator | None]:
        i = self._by_address.get(address)
        if i is None:
            return -1, None
        return i, self.validators[i]

    def get_by_index(self, index: int) -> Validator | None:
        if 0 <= index < len(self.validators):
            return self.validators[index]
        return None

    # -- commit verification (one batch per call) ---------------------
    def verify_commit(self, chain_id: str, block_id: BlockID, height: int, commit,
                      *, device=None) -> None:
        """All non-absent signatures must be valid; ForBlock power > 2/3.
        Raises ValueError on failure.  (reference :662-712)"""
        batch_verify_commits(
            [CommitVerifyJob(self, chain_id, block_id, height, commit, mode="full")],
            device=device,
        )

    def verify_commit_light(self, chain_id: str, block_id: BlockID, height: int, commit,
                            *, device=None) -> None:
        """ForBlock signatures verified until cumulative power > 2/3, with
        the reference's in-order early exit (:720-766)."""
        batch_verify_commits(
            [CommitVerifyJob(self, chain_id, block_id, height, commit, mode="light")],
            device=device,
        )

    def verify_commit_light_trusting(self, chain_id: str, commit, trust_level: Fraction,
                                     *, device=None) -> None:
        """Address-matched verification to trust_level of this set's power
        (light-client skipping verification, reference :776-830)."""
        if trust_level.denominator == 0:
            raise ValueError("trustLevel has zero denominator")
        if commit is None:
            raise ValueError("nil commit")
        needed = self.total_voting_power() * trust_level.numerator // trust_level.denominator
        bv = TorchBatchVerifier(device=device)
        entries = []
        seen: dict[int, int] = {}
        running = 0
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val_idx, val = self.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen:
                raise ValueError(
                    f"double vote from validator {val_idx} ({seen[val_idx]} and {idx})"
                )
            seen[val_idx] = idx
            entries.append((idx, val, val.voting_power))
            running += val.voting_power
            if running > needed:
                break
        msgs = commit.vote_sign_bytes_batch(chain_id, [e[0] for e in entries])
        for (idx, val, _power), msg in zip(entries, msgs):
            bv.add(val.pub_key, msg, commit.signatures[idx].signature)
        _, oks = bv.verify()
        tallied = 0
        for ok, (idx, _val, power) in zip(oks, entries):
            if not ok:
                raise ValueError(f"wrong signature (#{idx})")
            tallied += power
            if tallied > needed:
                return
        raise ValueError(f"insufficient voting power: got {tallied}, needed >{needed}")

    def _check_commit_basics(self, chain_id: str, block_id: BlockID, height: int, commit) -> None:
        if commit is None:
            raise ValueError("nil commit")
        if self.size() != len(commit.signatures):
            raise ValueError(
                f"invalid commit: {self.size()} vals, {len(commit.signatures)} sigs"
            )
        if height != commit.height:
            raise ValueError(f"invalid commit height: want {height}, got {commit.height}")
        if block_id != commit.block_id:
            raise ValueError("invalid commit: wrong block ID")


@dataclass
class CommitVerifyJob:
    """One commit to verify as part of a multi-commit batch.

    mode='full'  → VerifyCommit semantics (every non-absent signature must
                   be valid; ForBlock power > 2/3)          (reference :662)
    mode='light' → VerifyCommitLight semantics (ForBlock signatures in
                   order until cumulative power > 2/3; later signatures
                   never consulted)                         (reference :720)
    """

    val_set: ValidatorSet
    chain_id: str
    block_id: BlockID
    height: int
    commit: object
    mode: str = "full"  # 'full' | 'light'


def batch_verify_commits(jobs: list[CommitVerifyJob], *, device=None) -> None:
    """Verify many commits as ONE batch — one kernel launch for a whole
    blocksync window or light-client range (reference
    blockchain/v0/reactor.go:517, light/verifier.go:81,141 verify them
    one commit at a time).  Per-commit accept/reject semantics are those
    of verify_commit / verify_commit_light; raises ValueError naming the
    first failing job's height."""
    bv = TorchBatchVerifier(device=device)
    plans = []  # (job, entries=[(sig_batch_idx, val_idx, power)], needed)
    n = 0
    for job in jobs:
        vs, commit = job.val_set, job.commit
        vs._check_commit_basics(job.chain_id, job.block_id, job.height, commit)
        needed = vs.total_voting_power() * 2 // 3
        sel = []
        running = 0
        for idx, cs in enumerate(commit.signatures):
            if job.mode == "light":
                if not cs.for_block():
                    continue
            elif cs.absent():
                continue
            sel.append(idx)
            if job.mode == "light":
                running += vs.validators[idx].voting_power
                if running > needed:
                    break
        msgs = commit.vote_sign_bytes_batch(job.chain_id, sel)
        entries = []
        for idx, msg in zip(sel, msgs):
            val = vs.validators[idx]
            bv.add(val.pub_key, msg, commit.signatures[idx].signature)
            entries.append((n, idx, val.voting_power))
            n += 1
        plans.append((job, entries, needed))
    _, oks = bv.verify() if n else (True, [])
    for job, entries, needed in plans:
        tallied = 0
        for sig_i, idx, power in entries:
            if not oks[sig_i]:
                raise ValueError(
                    f"wrong signature (#{idx}) in commit for height {job.height}"
                )
            # light entries stop at the +2/3 cutoff by construction, so
            # every collected signature counts; full mode tallies ForBlock
            if job.mode == "light" or job.commit.signatures[idx].for_block():
                tallied += power
        if tallied <= needed:
            raise ValueError(
                f"insufficient voting power for height {job.height}: "
                f"got {tallied}, needed >{needed}"
            )
