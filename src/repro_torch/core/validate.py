"""Array-native validity oracle for compiled schedules.

The legacy verifier (``schedule.verify_broadcast`` et al.) replays a
schedule round by round over per-processor Python sets — correct, but
per-``Msg`` and therefore unusable on the O(p^2)-message alltoall families
at paper scale, and unusable on :class:`~repro_torch.core.schedule_ir.
CompiledSchedule` at all (the IR has no ``Msg`` objects).  This module is
the vectorized counterpart: it checks the same no-intra-round-forwarding
data-flow semantics directly on the IR's CSR block arrays, so every
*optimized* schedule coming out of :mod:`repro_torch.core.passes` is
machine-checked rather than trusted.

The trick that removes the sequential scan: ownership only ever *grows*
(senders retain what they send), so a schedule is causally valid iff every
(sender, block) requirement at round ``r`` is covered by initial ownership
or by some acquisition — a message delivering that block to that processor
— at a round strictly before ``r``.  Strictness grounds the induction:
chains of forwarding are fine, same-round forwarding is not, and cycles are
impossible.  Both sides reduce to two event arrays

* requirements: ``(src, blk)`` keyed, valued by the message's round,
* acquisitions: ``(dst, blk)`` keyed, valued by the message's round,

and one sort: the earliest acquisition round per key (``lexsort`` + group
firsts), then a ``searchsorted`` membership test for every requirement.
O(E log E) total for E block-hop events — no per-round loop at all.

Initial ownership never needs materializing: it is analytic per op
(root holds everything for broadcast/scatter; ``blk // p == proc`` for the
alltoall block encoding ``a*p + b``), which is also what lets the oracle
run at paper scale where the dense ownership matrix (p x p^2 bools for
alltoall) would never fit.

Postconditions are checked the same way: the op's required final
(owner, block) pairs must each be analytic or acquired at some round.

Besides the pass/fail oracle this module also *exports* the data-flow
structure it computes along the way: :func:`block_dependencies` turns the
block-hop events into a message-level dependency DAG (message -> the
earliest messages that deliver the blocks it forwards), which is what the
``ReorderRounds`` list scheduler in :mod:`repro_torch.core.passes` consumes to
re-pack messages into earlier rounds without breaking causality.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedule_ir import CompiledSchedule, segmented_arange

__all__ = [
    "ValidationReport",
    "initial_holds",
    "validate_schedule",
    "check_schedule",
    "block_dependencies",
    "rewrite_window",
    "window_hop_fraction",
    "revalidate_schedule",
]


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """Outcome of one oracle run.  ``ok`` is the verdict; the rest is
    forensics (first causality violation, count of undelivered final
    blocks) for debugging a broken rewrite."""

    ok: bool
    op: str
    algorithm: str
    num_msgs: int
    num_block_hops: int
    causality_violations: int
    first_violation: str | None
    missing_final: int
    first_missing: str | None = None

    def raise_if_invalid(self) -> "ValidationReport":
        if not self.ok:
            # Failure forensics: when armed (forensics.enable or
            # REPRO_FORENSICS), dump the flight recorder + metrics before
            # raising so chaos/CI oracle violations are diagnosable
            # post-mortem.  Unarmed (the default — including the test
            # suite's intentional-corruption checks) this is a no-op.
            from repro_torch.obs.forensics import auto_dump

            auto_dump("oracle_violation", extra=dataclasses.asdict(self))
            raise AssertionError(
                f"invalid {self.op}/{self.algorithm} schedule: "
                f"{self.causality_violations} causality violation(s) "
                f"({self.first_violation}), {self.missing_final} final "
                f"block(s) undelivered ({self.first_missing})"
            )
        return self


def initial_holds(op: str, p: int, procs: np.ndarray, blks: np.ndarray):
    """Vectorized initial-ownership predicate for the op's block encoding
    (root is always 0 — the ``ALGORITHMS`` registry generates root=0
    schedules).  broadcast: root holds the whole payload (any chunk ids);
    scatter: root holds every block; alltoall: block ``a*p + b`` starts at
    ``a``."""
    if op in ("broadcast", "scatter"):
        return procs == 0
    if op == "alltoall":
        return blks // p == procs
    raise ValueError(f"unknown op {op!r}")


def _events(cs: CompiledSchedule):
    """(round, src, dst, blk) per block-hop, flattened over the CSR."""
    nblk = np.diff(cs.blk_ptr)
    rid = np.repeat(cs.round_ids(), nblk)
    src = np.repeat(cs.src, nblk)
    dst = np.repeat(cs.dst, nblk)
    return rid, src, dst, cs.blk_ids


def block_dependencies(
    cs: CompiledSchedule,
    *,
    lift_zero_block: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Message-level block-dependency DAG as a CSR ``(dep_ptr, dep_ids)``.

    Message ``i`` depends on provider messages ``dep_ids[dep_ptr[i]:
    dep_ptr[i+1]]`` (unique, ascending): for every block ``i`` sends but its
    source does not hold analytically, the provider is the *earliest*
    message in the schedule that delivers that ``(src, blk)`` pair.  An edge
    ``j -> i`` therefore means "any rewrite must schedule message ``j``
    strictly before message ``i``"; scheduling every message after its
    providers reproduces exactly the oracle's strict-acquisition rule, so a
    list scheduler that honours these edges cannot create a causality
    violation.

    Linking only the earliest provider (rather than every delivery of the
    block) is sound for earliest-round packing — providers are processed
    first in original round order — and keeps the graph O(hops).

    **Zero-block messages**: ``schedule_ir.split_messages`` with a
    factor above the block count emits parts that carry payload bytes but
    *no* block ids — their bytes belong to a block attributed to a
    co-``(round, src, dst)`` sibling, so they have no block-hop events and,
    naively, no causality edges.  A message-granularity packer would be free
    to hoist such a part ahead of its payload's producer (or strand it
    behind a forwarder that thinks the block already arrived).  With
    ``lift_zero_block=True`` (the default) the export pins the intended
    "split parts are one payload" semantics: a zero-block message inherits
    the dependency set of its block-carrying co-``(round, src, dst)``
    siblings, and every consumer of a block additionally depends on the
    zero-block siblings of its provider (a block is usable only strictly
    after *all* parts of the delivering payload).  Round-granularity passes
    (``ReorderRounds``/``CompactRounds``) never separate co-round siblings,
    so they are safe either way; the lift is what makes message-granularity
    packing (``ColorRounds``) sound on split schedules.

    Raises ``ValueError`` if the schedule has no block metadata and
    ``AssertionError`` if some requirement has no provider at all (the
    schedule is invalid; run :func:`validate_schedule` for forensics).
    """
    if not cs.has_blocks:
        raise ValueError(
            "schedule carries no block metadata; regenerate with "
            "compile_schedule(..., with_blocks=True) or an *_ir generator"
        )
    M = cs.num_msgs
    nblk = np.diff(cs.blk_ptr)
    rid, src, dst, blk = _events(cs)
    mid = np.repeat(np.arange(M, dtype=np.int64), nblk)
    if blk.size:
        bmin = int(blk.min())
        bspan = int(blk.max()) - bmin + 1
    else:
        bmin, bspan = 0, 1

    # requirements: hops whose source does not hold the block analytically.
    # Checked *first*: a direct schedule (every sender ships its own data,
    # e.g. the kported/klane alltoalls) has no requirements at all, and
    # skipping the provider sort below makes the dependency export O(hops)
    # there instead of O(hops log hops).
    held0 = initial_holds(cs.op, cs.p, src, blk)
    need = ~held0
    req_keys = src[need] * bspan + (blk[need] - bmin)
    req_mid = mid[need]
    if not req_keys.size:
        return (
            np.zeros(M + 1, dtype=np.int64),
            np.empty(0, dtype=np.int64),
        )

    # earliest delivering message per (dst, blk) key
    acq_keys = dst * bspan + (blk - bmin)
    order = np.lexsort((mid, rid, acq_keys))
    sk = acq_keys[order]
    first = np.ones(sk.size, dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    uniq_keys = sk[first]
    provider = mid[order][first]

    if req_keys.size:
        if not uniq_keys.size:
            raise AssertionError(
                "schedule has block requirements but no acquisitions"
            )
        idx = np.minimum(np.searchsorted(uniq_keys, req_keys), uniq_keys.size - 1)
        if not bool((uniq_keys[idx] == req_keys).all()):
            raise AssertionError(
                "unsatisfiable block requirement (no message ever delivers "
                "it); the schedule is invalid — see validate_schedule"
            )
        prov_mid = provider[idx]
    else:
        prov_mid = np.empty(0, dtype=np.int64)

    # --- zero-block lift: split parts share their siblings' constraints ---
    if lift_zero_block and prov_mid.size and bool((nblk == 0).any()):
        mrid = cs.round_ids()
        gkey = (mrid * cs.p + cs.src) * cs.p + cs.dst
        _, gid = np.unique(gkey, return_inverse=True)
        G = int(gid.max()) + 1
        zmsg = np.flatnonzero(nblk == 0)
        zg = gid[zmsg]
        zsorted = zmsg[np.argsort(zg, kind="stable")]
        zcnt = np.bincount(zg, minlength=G)
        zptr = np.zeros(G + 1, dtype=np.int64)
        np.cumsum(zcnt, out=zptr[1:])

        def _expand(side_gids):
            """Zero-block siblings of each edge endpoint's group, flattened;
            returns (edge_index_per_new_entry, sibling_msg_ids)."""
            rep = zcnt[side_gids]
            eidx = np.repeat(np.arange(side_gids.size, dtype=np.int64), rep)
            base = np.repeat(zptr[side_gids], rep)
            return eidx, zsorted[base + segmented_arange(rep)]

        # requirement side: each zero-block sibling of a requirer inherits
        # the requirer's providers (the part carries the same payload).
        eidx, sibs = _expand(gid[req_mid])
        req_mid = np.concatenate([req_mid, sibs])
        prov_mid = np.concatenate([prov_mid, prov_mid[eidx]])
        # acquisition side: a consumer additionally waits for every
        # zero-block sibling of its provider (the block is usable only
        # after ALL parts of the delivering payload have arrived).
        eidx, sibs = _expand(gid[prov_mid])
        req_mid = np.concatenate([req_mid, req_mid[eidx]])
        prov_mid = np.concatenate([prov_mid, sibs])

    # unique (requirer, provider) edges, CSR over requirer
    if prov_mid.size:
        pair = np.unique(req_mid * M + prov_mid)
        dep_of = pair // M
        dep_ids = pair % M
        dep_ptr = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(np.bincount(dep_of, minlength=M), out=dep_ptr[1:])
    else:
        dep_ids = np.empty(0, dtype=np.int64)
        dep_ptr = np.zeros(M + 1, dtype=np.int64)
    return dep_ptr, dep_ids


def _membership(sorted_vals: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Boolean mask: which entries of ``x`` appear in the sorted unique
    array ``sorted_vals`` (vectorized searchsorted membership test)."""
    if sorted_vals.size == 0:
        return np.zeros(x.shape, dtype=bool)
    idx = np.minimum(np.searchsorted(sorted_vals, x), sorted_vals.size - 1)
    return sorted_vals[idx] == x


def validate_schedule(
    cs: CompiledSchedule, *, raise_on_error: bool = False
) -> ValidationReport:
    """Data-flow-check a compiled schedule against its op's semantics.

    Requires block metadata on the IR (``cs.has_blocks``); schedules
    compiled without blocks cannot be validated and raise ``ValueError``.
    """
    report = _validate(cs, None)
    if raise_on_error:
        report.raise_if_invalid()
    return report


def check_schedule(
    cs: CompiledSchedule, *, raise_on_error: bool = False
) -> ValidationReport:
    """Alias of :func:`validate_schedule` — the name the robustness tooling
    (chaos harness, repair tests) uses when the point is the *raising* mode:
    a failed check names the offending round/message (first causality
    violation) or the first undelivered final (owner, block) pair."""
    return validate_schedule(cs, raise_on_error=raise_on_error)


def _validate(
    cs: CompiledSchedule, affected: np.ndarray | None
) -> ValidationReport:
    """The oracle, optionally restricted to the hop chains of the sorted
    unique block ids in ``affected`` (the incremental path — see
    :func:`revalidate_schedule` for the soundness argument)."""
    if not cs.has_blocks:
        raise ValueError(
            "schedule carries no block metadata; regenerate with "
            "compile_schedule(..., with_blocks=True) or an *_ir generator"
        )
    p = cs.p
    rid, src, dst, blk = _events(cs)
    if affected is not None:
        keep = _membership(affected, blk)
        rid, src, dst, blk = rid[keep], src[keep], dst[keep], blk[keep]
    hops = int(blk.size)

    if hops:
        bmin = int(blk.min())
        bspan = int(blk.max()) - bmin + 1
    else:
        bmin, bspan = 0, 1

    def key_of(procs, blks):
        return procs * bspan + (blks - bmin)

    # earliest acquisition round per (dst, blk) key
    acq_keys = key_of(dst, blk)
    order = np.lexsort((rid, acq_keys))
    sk, sr = acq_keys[order], rid[order]
    first = np.ones(sk.size, dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    uniq_keys = sk[first]  # sorted unique acquisition keys
    min_round = sr[first]  # min round per key (round-sorted within key)

    # --- causality: every requirement analytic or acquired strictly before
    req_keys = key_of(src, blk)
    held0 = initial_holds(cs.op, p, src, blk)
    if uniq_keys.size:
        idx = np.minimum(
            np.searchsorted(uniq_keys, req_keys), uniq_keys.size - 1
        )
        acquired_before = (uniq_keys[idx] == req_keys) & (min_round[idx] < rid)
    else:
        acquired_before = np.zeros_like(held0)
    valid = held0 | acquired_before
    violations = int((~valid).sum())
    first_violation = None
    if violations:
        i = int(np.argmin(valid))  # first False in event order
        first_violation = (
            f"round {int(rid[i])}: {int(src[i])}->{int(dst[i])} sends block "
            f"{int(blk[i])} it does not hold"
        )

    # --- postcondition: op-required final (owner, block) pairs ------------
    if cs.op == "broadcast":
        universe = np.unique(cs.blk_ids)
        if universe.size == 0:
            universe = np.array([-1], dtype=np.int64)  # BCAST_BLOCK
        owners = np.repeat(np.arange(p, dtype=np.int64), universe.size)
        need = np.tile(universe, p)
    elif cs.op == "scatter":
        owners = np.arange(p, dtype=np.int64)
        need = owners
    elif cs.op == "alltoall":
        a = np.repeat(np.arange(p, dtype=np.int64), p)
        b = np.tile(np.arange(p, dtype=np.int64), p)
        owners, need = b, a * p + b
    else:  # pragma: no cover - initial_holds already rejects
        raise ValueError(f"unknown op {cs.op!r}")
    if affected is not None:
        fkeep = _membership(affected, need)
        owners, need = owners[fkeep], need[fkeep]
    fin0 = initial_holds(cs.op, p, owners, need)
    if uniq_keys.size:
        in_span = (need >= bmin) & (need < bmin + bspan)
        fkeys = key_of(owners, np.where(in_span, need, bmin))
        fidx = np.minimum(np.searchsorted(uniq_keys, fkeys), uniq_keys.size - 1)
        ffound = (uniq_keys[fidx] == fkeys) & in_span
    else:
        ffound = np.zeros_like(fin0)
    delivered = fin0 | ffound
    missing = int((~delivered).sum())
    first_missing = None
    if missing:
        i = int(np.argmin(delivered))
        first_missing = (
            f"final owner {int(owners[i])} never receives block {int(need[i])}"
        )

    return ValidationReport(
        ok=(violations == 0 and missing == 0),
        op=cs.op,
        algorithm=cs.algorithm,
        num_msgs=cs.num_msgs,
        num_block_hops=hops,
        causality_violations=violations,
        first_violation=first_violation,
        missing_final=missing,
        first_missing=first_missing,
    )


# ---------------------------------------------------------------------------
# Incremental revalidation: a rewrite that only touches a
# round window needs only its affected blocks' hop chains rechecked.
# ---------------------------------------------------------------------------


def rewrite_window(
    prev: CompiledSchedule, new: CompiledSchedule
) -> tuple[int, int, int] | None:
    """Minimal differing round window between two schedules, as a half-open
    triple ``(a, b_prev, b_new)``: rounds ``[0, a)`` are identical in both,
    rounds ``[b_prev, R_prev)`` of ``prev`` equal rounds ``[b_new, R_new)``
    of ``new`` round-for-round, and every difference lives in
    ``prev[a:b_prev]`` vs ``new[a:b_new]``.

    "Identical" is in the oracle's terms — same per-round ``(src, dst,
    blocks)`` message sequences (``elems`` is ignored: data-flow validity
    does not depend on payload sizes).  Identical schedules yield an empty
    window (``a == b_prev == b_new``).  Returns ``None`` when the two
    schedules are not diffable (different op/p, or missing block
    metadata) — callers must fall back to a full oracle run.

    Cost: O(M + hops) array comparisons, no sorting.
    """
    if (
        prev.op != new.op
        or prev.p != new.p
        or not (prev.has_blocks and new.has_blocks)
    ):
        return None
    Rp, Rn = prev.num_rounds, new.num_rounds
    Mp, Mn = prev.num_msgs, new.num_msgs
    nb_p, nb_n = np.diff(prev.blk_ptr), np.diff(new.blk_ptr)

    # --- longest common message prefix (src, dst, block slice) ------------
    L = min(Mp, Mn)
    diff = (
        (prev.src[:L] != new.src[:L])
        | (prev.dst[:L] != new.dst[:L])
        | (nb_p[:L] != nb_n[:L])
    )
    m0 = int(np.argmax(diff)) if bool(diff.any()) else L
    Lb = min(prev.blk_ids.size, new.blk_ids.size)
    bdiff = prev.blk_ids[:Lb] != new.blk_ids[:Lb]
    b0 = int(np.argmax(bdiff)) if bool(bdiff.any()) else Lb
    # the first message whose block slice reaches past the common block
    # prefix caps the message prefix (counts agree up to m0, so prev's
    # blk_ptr is the shared offset table there)
    m0 = min(m0, int(np.searchsorted(prev.blk_ptr, b0, side="right")) - 1)

    # --- longest common message suffix ------------------------------------
    diff_s = (
        (prev.src[Mp - L:][::-1] != new.src[Mn - L:][::-1])
        | (prev.dst[Mp - L:][::-1] != new.dst[Mn - L:][::-1])
        | (nb_p[Mp - L:][::-1] != nb_n[Mn - L:][::-1])
    )
    t = int(np.argmax(diff_s)) if bool(diff_s.any()) else L
    bdiff_s = prev.blk_ids[prev.blk_ids.size - Lb:][::-1] != new.blk_ids[
        new.blk_ids.size - Lb:
    ][::-1]
    bt = int(np.argmax(bdiff_s)) if bool(bdiff_s.any()) else Lb
    if t:
        tail_cum = np.cumsum(nb_p[::-1][:t])
        t = int(np.searchsorted(tail_cum, bt, side="right"))

    # --- round-align the prefix -------------------------------------------
    Rm = min(Rp, Rn)
    pref_ok = (
        prev.round_ptr[: Rm + 1] == new.round_ptr[: Rm + 1]
    ) & (new.round_ptr[: Rm + 1] <= m0)
    a = (int(np.argmin(pref_ok)) if not bool(pref_ok.all()) else Rm + 1) - 1

    # --- round-align the suffix -------------------------------------------
    suf_ok = (
        prev.round_ptr[Rp - Rm:][::-1] - Mp
        == new.round_ptr[Rn - Rm:][::-1] - Mn
    ) & (Mp - prev.round_ptr[Rp - Rm:][::-1] <= t)
    rs = (int(np.argmin(suf_ok)) if not bool(suf_ok.all()) else Rm + 1) - 1
    rs = min(rs, Rp - a, Rn - a)
    return a, Rp - rs, Rn - rs


def window_hop_fraction(
    prev: CompiledSchedule,
    new: CompiledSchedule,
    window: tuple[int, int, int],
) -> float:
    """Fraction of the two schedules' block-hop events that fall inside a
    :func:`rewrite_window` — the cheap proxy callers use to decide between
    the incremental and the full oracle."""
    a, bp, bn = window
    hp = int(
        prev.blk_ptr[prev.round_ptr[bp]] - prev.blk_ptr[prev.round_ptr[a]]
    )
    hn = int(new.blk_ptr[new.round_ptr[bn]] - new.blk_ptr[new.round_ptr[a]])
    total = int(prev.blk_ids.size + new.blk_ids.size)
    return (hp + hn) / total if total else 0.0


def revalidate_schedule(
    new: CompiledSchedule,
    *,
    prev: CompiledSchedule,
    window: tuple[int, int, int] | None = None,
    raise_on_error: bool = False,
) -> ValidationReport:
    """Incrementally validate ``new``, given that ``prev`` is oracle-valid
    and differs from ``new`` only inside ``window`` (computed via
    :func:`rewrite_window` when not supplied).

    Only the hop chains of the *affected blocks* — blocks with at least one
    hop inside either schedule's window — are rechecked, against the whole
    of ``new`` (an affected block's earliest acquisition may sit outside
    the window).  Soundness of skipping the rest: an unaffected block's
    hops all live in the common prefix/suffix, where round ids are
    unchanged (prefix) or uniformly shifted (suffix), so the strict
    earliest-acquisition-before-requirement order the full oracle checks is
    preserved verbatim from ``prev``; its final delivery likewise.  The
    verdict therefore equals the full oracle's whenever the precondition
    holds (``prev`` valid + window-confined rewrite) — pinned by the
    incremental ≡ full property test.  The report's violation/hop counts
    cover the checked subset only.

    Falls back to the full oracle when the schedules are not diffable.
    """
    if window is None:
        window = rewrite_window(prev, new)
    if window is None:
        return validate_schedule(new, raise_on_error=raise_on_error)
    a, bp, bn = window
    affected = np.unique(
        np.concatenate(
            [
                prev.blk_ids[
                    prev.blk_ptr[prev.round_ptr[a]]:
                    prev.blk_ptr[prev.round_ptr[bp]]
                ],
                new.blk_ids[
                    new.blk_ptr[new.round_ptr[a]]:
                    new.blk_ptr[new.round_ptr[bn]]
                ],
            ]
        )
    )
    report = _validate(new, affected)
    if raise_on_error:
        report.raise_if_invalid()
    return report
