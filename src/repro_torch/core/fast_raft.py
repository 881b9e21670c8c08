"""Fast Raft (Castiglia, Goldberg & Patterson 2020) on top of classic Raft.

Fast track (paper section 2.2):

  round 1  proposer  -> ALL    FastPropose(index=i, entry=e)
  round 2  acceptors -> leader FastVote(i, e)        (tentative insert at i)
  round 3  leader    -> ALL    FastFinalize(i, e)    once votes >= ceil(3M/4)

versus the classic track for a non-leader proposer (forward -> AppendEntries
-> acks -> commit-bearing heartbeat = 4 rounds). The fast track commits in 3
rounds from any proposer and removes the leader as the serialization point
for replication fan-out.

Design decisions (and the safety arguments behind them):

* The authoritative log (``self.log``) stays contiguous and append-only as in
  classic Raft. Fast-track slots live in a sparse overlay ``self.fast_slots``
  until FINALIZED *and* contiguous, at which point they merge into the log.
  Every classic-Raft invariant holds by construction; the paper's
  "over-writable log" is confined to the overlay.
* An acceptor votes for the FIRST proposal it sees per (term, index) —
  first-come-first-served, as in Fast Paxos — and the tentative entry is part
  of persistent state (the durable vote).
* Fast commit = ceil(3M/4) votes *and* slot contiguity at the leader. A
  slot that reaches quorum before its gap fills (vote jitter) is HELD
  finalized in the overlay and merges the moment the gap fills; if the gap
  never fills, a liveness timer re-routes the held entry through the classic
  track (safe: a non-contiguous slot was never observable as committed).
* Recovery (new leader): vote-reply tails carry each voter's overlay. In a
  sample of R granted votes, an entry that MAY have fast-committed appears
  >= fq + R - M times (quorum intersection), and no two entries can both
  reach that bound for one slot (2*(fq + R - M) > R for all M >= 2, R >=
  majority). Such entries are re-adopted AT THEIR ORIGINAL INDEX, overwriting
  uncommitted classic entries if necessary — a committed classic entry at the
  same index is impossible because majority(M) + fq(M) > M means the two
  holder sets would have to overlap in a node that accepted both, which the
  per-slot first-come-first-served rule forbids. Sub-threshold tail entries
  provably did not commit and are optionally re-appended for liveness.
* EntryId-level dedup makes every fallback idempotent: a command commits at
  most once no matter how many tracks and retries it traveled.
* Batched fast track: a client burst rides ONE multi-slot FastPropose
  window (entries for consecutive slots), acceptors vote per-slot FCFS and
  reply with ONE batched FastVote, and the leader's resulting
  finalizations leave as batched FastFinalize windows — so an N-command
  burst costs the same 2 message rounds as a single command. Safety is
  unchanged: a window is semantically exactly N single-slot proposals.

Known liveness (not safety) gap, matching the paper's own observations about
lossy networks: if the leader's own slot was claimed by a conflicting
proposal, it lacks the losing command's payload (FastVotes carry ids, not
payloads) and cannot fall the loser back itself; the proposer's inflight
timeout re-routes the command through the classic track instead.

Linearizable reads under the fast track (the read-visibility rule): a
fast-committed write only becomes client-visible (acked) through
``_merge_finalized`` -> ``_advance_commit`` on the LEADER, which bumps
``commit_index`` and applies the entry synchronously BEFORE the
FastFinalize broadcast leaves the handler. Finalized-but-held slots
(non-contiguous, awaiting their gap) are NOT committed and were never
acked, so they are invisible to reads by construction. The base read path
(ReadIndex + leases, ``repro_torch.core.raft``) therefore stays exact here:
``read_index = commit_index`` covers every fast-acked write by the time
any later read can arrive, and ``_advance_commit``'s pending-read drain
releases queued reads the instant a fast-track merge advances the
read-visible index.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.raft import Outputs, RaftNode, is_config_command, skeleton_entry
from repro_torch.core.types import (
    AppendEntriesArgs,
    Entry,
    EntryId,
    FastFinalize,
    FastPropose,
    FastVote,
    ForwardOperation,
    NodeId,
    Role,
    Slot,
    SlotState,
    fast_quorum,
)


@dataclasses.dataclass(slots=True)
class _InflightProposal:
    index: int
    command: Any
    entry_id: EntryId
    started_at: float
    fell_back: bool = False


@dataclasses.dataclass(slots=True)
class _SlotTally:
    """Leader-side vote accounting for one fast-track slot."""

    votes: Dict[EntryId, Set[NodeId]] = dataclasses.field(default_factory=dict)
    entries: Dict[EntryId, Entry] = dataclasses.field(default_factory=dict)
    first_vote_at: float = 0.0
    resolved: bool = False


class FastRaftNode(RaftNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.config.fast_track = True
        # Sparse overlay: index -> Slot (TENTATIVE or FINALIZED-awaiting-merge).
        self.fast_slots: Dict[int, Slot] = {}
        # Proposer state.
        self.inflight: Dict[EntryId, _InflightProposal] = {}
        self._next_fast_hint = 0
        # Leader tallies: index -> _SlotTally.
        self.tallies: Dict[int, _SlotTally] = {}
        # Leader: finalized-but-non-contiguous slots awaiting their gap.
        self._finalized_held: Dict[int, float] = {}
        # When set (window-vote handling), finalized slots accumulate here
        # and are broadcast as batched FastFinalize windows afterwards.
        self._finalize_accum: Optional[List[Tuple[int, Entry]]] = None
        # Ack piggybacking (config.ack_piggyback): single-slot FastVotes
        # cast in one delivery tick, buffered per leader as (index,
        # entry_id) pairs and flushed as ONE FastVote (head vote +
        # multi_votes) by _flush_acks. _vote_buf_term is the term the
        # buffered votes were cast in — the flushed message is stamped
        # with it, so a term bump mid-tick leaves the votes exactly as
        # stale as an in-flight unbuffered message would be.
        self._vote_buf: Dict[NodeId, List[Tuple[int, EntryId]]] = {}
        self._vote_buf_term = 0
        # Liveness nicety: re-propose sub-threshold entries seen during
        # recovery (safe — dedup by entry_id).
        self.readopt_uncommitted = True

    # ------------------------------------------------------------ proposing

    def _submit_mode(self) -> str:
        fast = (
            self.role is not Role.LEADER
            and len(self.inflight) < self.config.max_fast_inflight
            and self.leader_id is not None
        )
        return "fast" if fast else "classic"

    def _non_leader_submit(self, command: Any, entry_id: EntryId, now: float) -> Outputs:
        if (
            len(self.inflight) >= self.config.max_fast_inflight
            or self.leader_id is None
            or is_config_command(command)  # config entries are leader-appended only
        ):
            return super()._non_leader_submit(command, entry_id, now)
        return self._fast_propose_window([(command, entry_id)], now)

    def _non_leader_submit_batch(self, pairs, now: float) -> Outputs:
        if (
            len(self.inflight) + len(pairs) > self.config.max_fast_inflight
            or self.leader_id is None
            or any(is_config_command(c) for c, _ in pairs)
        ):
            return super()._non_leader_submit_batch(pairs, now)
        out: Outputs = []
        w = max(1, self.config.max_batch_entries)
        for i in range(0, len(pairs), w):
            out += self._fast_propose_window(pairs[i : i + w], now)
        return out

    def _fast_propose_window(self, pairs, now: float) -> Outputs:
        """One fast-track round 1 for consecutive slots: a single FastPropose
        (with a window for >1 entries) to all peers plus our own batched
        vote to the leader."""
        base = self._choose_fast_index(len(pairs))
        entries = []
        for off, (command, entry_id) in enumerate(pairs):
            index = base + off
            entry = Entry(term=self.term, command=command, entry_id=entry_id,
                          proposed_at=now)
            self.inflight[entry_id] = _InflightProposal(index, command, entry_id, now)
            # Tentatively accept our own proposal (we are one of the M acceptors).
            self.fast_slots[index] = Slot(entry.clone(), SlotState.TENTATIVE)
            entries.append(entry)
        self._count("fast_proposals", len(entries))

        if len(entries) == 1:
            propose = FastPropose(term=self.term, src=self.id, index=base,
                                  entry=entries[0])
        else:
            propose = FastPropose(term=self.term, src=self.id, index=base,
                                  window=tuple(entries))
        out: Outputs = [(p, propose) for p in self.peers()]
        if self.role is Role.LEADER:
            out += self._apply_window_votes(
                base, [e.entry_id for e in entries], self.id, now
            )
        elif len(entries) == 1:
            out.append((self.leader_id,
                        FastVote(term=self.term, src=self.id, index=base,
                                 entry_id=entries[0].entry_id, voter=self.id)))
        else:
            out.append((self.leader_id,
                        FastVote(term=self.term, src=self.id, index=base, voter=self.id,
                                 window_votes=tuple(e.entry_id for e in entries))))
        self._count("msgs_out", len(out))
        return out

    def _choose_fast_index(self, span: int = 1) -> int:
        """Reserve ``span`` consecutive slots above everything we know of."""
        hi = max(
            self.last_log_index(),
            max(self.fast_slots.keys(), default=0),
            self._next_fast_hint,
        )
        self._next_fast_hint = hi + span
        return hi + 1

    def _append_and_replicate(self, pairs, now: float) -> Outputs:
        # Held finalized slots take their indexes before classic traffic;
        # classic appends then shadow any remaining overlay reservations at
        # or below their index (displaced proposals re-route via timeout).
        self._merge_finalized(now)
        out = super()._append_and_replicate(pairs, now)
        for index in list(self.fast_slots.keys()):
            if index <= self.last_log_index():
                self.fast_slots.pop(index)
                self._finalized_held.pop(index, None)
        return out

    # ------------------------------------------------------------- acceptors

    def _handle_FastPropose(self, msg: FastPropose, now: float) -> Outputs:
        if msg.term < self.term:
            return []
        window = msg.window if msg.window else (
            (msg.entry,) if msg.entry is not None else ()
        )
        if not window:
            return []
        # Per-slot first-come-first-served acceptance, exactly as if the
        # window had arrived as len(window) single proposals; the reply is
        # ONE (possibly batched) FastVote.
        accepted: List[Optional[EntryId]] = []
        for off, entry in enumerate(window):
            accepted.append(self._accept_fast_slot(msg.index + off, entry))
        if not any(eid is not None for eid in accepted):
            return []
        if len(accepted) == 1:
            return self._emit_fast_vote(msg.index, accepted[0], now)
        return self._emit_fast_window_vote(msg.index, accepted, now)

    def _accept_fast_slot(self, index: int, entry: Entry) -> Optional[EntryId]:
        """FCFS acceptance for one slot; returns the entry_id we vote for
        (None = refuse)."""
        if index <= self.snapshot_last_index:
            return None  # compacted: slot is committed history
        if is_config_command(entry.command):
            # Membership changes never ride the fast track: the entry that
            # REDEFINES quorums must not commit through a quorum rule that
            # is itself in flux. They are leader-appended classic entries.
            self._count("fast_rejects")
            return None
        authoritative = self.slot(index)
        if authoritative is not None:
            # Classic track already owns this index. Vote only if it's the
            # same entry (harmless); otherwise the proposal is dead here.
            if not authoritative.entry.same_entry(entry):
                self._count("fast_rejects")
                return None
        else:
            held = self.fast_slots.get(index)
            if held is None:
                # Witness acceptors hold payload-free skeletons even in the
                # fast-slot overlay; FCFS conflict detection only compares
                # EntryIds (same_entry), so votes are unaffected.
                e = skeleton_entry(entry) if self.is_witness() else entry.clone()
                self.fast_slots[index] = Slot(e, SlotState.TENTATIVE)
                self._next_fast_hint = max(self._next_fast_hint, index)
            elif not held.entry.same_entry(entry):
                self._count("fast_conflicts")
                return None  # first-come-first-served: keep existing vote
        return entry.entry_id

    def _emit_fast_vote(self, index: int, entry_id: Optional[EntryId], now: float) -> Outputs:
        if entry_id is None:
            return []
        if self.role is Role.LEADER:
            return self._record_fast_vote(index, entry_id, self.id, now)
        if self.leader_id is None:
            return []
        if self.config.ack_piggyback:
            # Fold same-tick single-slot votes into one FastVote per
            # leader per delivery tick (flushed by _flush_acks).
            if self._ack_buf_time < 0 or not self._vote_buf:
                self._vote_buf_term = self.term
            self._vote_buf.setdefault(self.leader_id, []).append(
                (index, entry_id)
            )
            self._ack_buf_time = now
            return []
        return [
            (
                self.leader_id,
                FastVote(term=self.term, src=self.id, index=index,
                         entry_id=entry_id, voter=self.id),
            )
        ]

    def _emit_fast_window_vote(
        self, base: int, accepted: List[Optional[EntryId]], now: float
    ) -> Outputs:
        if self.role is Role.LEADER:
            return self._apply_window_votes(base, accepted, self.id, now)
        if self.leader_id is None:
            return []
        return [
            (
                self.leader_id,
                FastVote(term=self.term, src=self.id, index=base, voter=self.id,
                         window_votes=tuple(accepted)),
            )
        ]

    # ---------------------------------------------------------- leader side

    def _handle_FastVote(self, msg: FastVote, now: float) -> Outputs:
        if self.role is not Role.LEADER or msg.term < self.term:
            return []
        if msg.window_votes:
            return self._apply_window_votes(
                msg.index, list(msg.window_votes), msg.voter, now
            )
        if msg.multi_votes:
            # Piggybacked vote: the head (index, entry_id) plus folded
            # same-tick votes. Record them all inside one finalize-accum
            # scope so slots they complete leave as batched FastFinalize
            # windows (same coalescing as window votes).
            outer = self._finalize_accum is None
            if outer:
                self._finalize_accum = []
            out: Outputs = []
            try:
                votes = [(msg.index, msg.entry_id)] + list(msg.multi_votes)
                for index, eid in votes:
                    if eid is not None:
                        out += self._record_fast_vote(index, eid, msg.voter, now)
            finally:
                if outer:
                    acc, self._finalize_accum = self._finalize_accum, None
                    out += self._broadcast_finalize_windows(acc)
            return out
        if msg.entry_id is None:
            return []
        return self._record_fast_vote(msg.index, msg.entry_id, msg.voter, now)

    def _apply_window_votes(
        self, base: int, votes: List[Optional[EntryId]], voter: NodeId, now: float
    ) -> Outputs:
        """Record a batched vote; coalesce any resulting finalizations into
        batched FastFinalize windows instead of one broadcast per slot."""
        outer = self._finalize_accum is None
        if outer:
            self._finalize_accum = []
        out: Outputs = []
        try:
            for off, eid in enumerate(votes):
                if eid is not None:
                    out += self._record_fast_vote(base + off, eid, voter, now)
        finally:
            if outer:
                acc, self._finalize_accum = self._finalize_accum, None
                out += self._broadcast_finalize_windows(acc)
        return out

    def _broadcast_finalize_windows(self, acc: List[Tuple[int, Entry]]) -> Outputs:
        if not acc:
            return []
        acc.sort(key=lambda kv: kv[0])
        runs: List[List[Tuple[int, Entry]]] = [[acc[0]]]
        for index, entry in acc[1:]:
            if index == runs[-1][-1][0] + 1:
                runs[-1].append((index, entry))
            else:
                runs.append([(index, entry)])
        out: Outputs = []
        for run in runs:
            base = run[0][0]
            if len(run) == 1:
                msg = FastFinalize(term=self.term, src=self.id, index=base,
                                   entry=run[0][1], leader_commit=self.commit_index)
            else:
                msg = FastFinalize(term=self.term, src=self.id, index=base,
                                   window=tuple(e for _, e in run),
                                   leader_commit=self.commit_index)
            out += [(p, msg) for p in self.peers()]
        self._count("msgs_out", len(out))
        return out

    def _record_fast_vote(
        self, index: int, entry_id: EntryId, voter: NodeId, now: float
    ) -> Outputs:
        if self._seen(entry_id):
            return []  # already authoritative (fast-merged or classicized)
        tally = self.tallies.setdefault(index, _SlotTally(first_vote_at=now))
        if tally.resolved:
            return []
        tally.votes.setdefault(entry_id, set()).add(voter)
        s = self.fast_slots.get(index)
        if s is not None and s.entry.entry_id == entry_id:
            tally.entries.setdefault(entry_id, s.entry)

        supporters = tally.votes[entry_id]
        # Fast commit requires ceil(3V/4) of EVERY active voter set (both
        # halves during a joint config change); learner votes never count —
        # ClusterConfig.fast_ok intersects with the voter sets.
        if self.cluster_config.fast_ok(supporters) and entry_id in tally.entries:
            return self._finalize_fast_slot(index, tally.entries[entry_id], now)
        # Definitive conflict: no candidate can still reach a fast quorum
        # in every active voter set (per-slot FCFS votes never change).
        cast = set().union(*tally.votes.values())
        if len(tally.votes) > 1 and not any(
            self.cluster_config.fast_possible(v, cast)
            for v in tally.votes.values()
        ):
            return self._fallback_slot(index, now)
        return []

    def _finalize_fast_slot(self, index: int, entry: Entry, now: float) -> Outputs:
        tally = self.tallies.get(index)
        if tally is not None:
            tally.resolved = True
        if self.slot(index) is not None or self._seen(entry.entry_id):
            return []  # classic track already owns this index / entry
        # Quorum reached. If not yet contiguous (vote jitter can complete
        # slot k+1 before slot k), HOLD the finalized slot in the overlay;
        # it merges the moment the gap fills. A liveness timer re-routes
        # held slots through the classic track if the gap never fills
        # (safe: a non-contiguous slot was never observable as committed).
        self.fast_slots[index] = Slot(entry.clone(), SlotState.FINALIZED)
        self._count("fast_commits")
        if index != self.last_log_index() + 1:
            self._finalized_held[index] = now
            self._count("fast_holds")
        self._merge_finalized(now)
        if self._finalize_accum is not None:
            # Window-vote context: defer the broadcast so consecutive slots
            # finalized by one batched vote leave as one FastFinalize window.
            self._finalize_accum.append((index, entry))
            return []
        out: Outputs = [
            (
                p,
                FastFinalize(term=self.term, src=self.id, index=index,
                             entry=entry, leader_commit=self.commit_index),
            )
            for p in self.peers()
        ]
        self._count("msgs_out", len(out))
        return out

    def _fallback_slot(self, index: int, now: float) -> Outputs:
        """Conflict or timeout: push the slot's candidates onto the classic
        track, best-supported first. Idempotent thanks to entry_id dedup."""
        tally = self.tallies.get(index)
        if tally is None or tally.resolved:
            return []
        tally.resolved = True
        self._count("fast_fallbacks")
        ranked = sorted(
            tally.votes.keys(),
            key=lambda eid: (-len(tally.votes[eid]), str(eid)),
        )
        out: Outputs = []
        for eid in ranked:
            entry = tally.entries.get(eid)
            if entry is None:
                continue  # payload unknown; proposer's timeout re-routes it
            if self.metrics is not None:
                self.metrics.fell_back(eid, now)
            out += super()._leader_append(entry.command, eid, now)
        return out

    # ------------------------------------------------------------ finalize

    def _handle_FastFinalize(self, msg: FastFinalize, now: float) -> Outputs:
        if msg.term < self.term:
            return []
        # Finalize comes from the live leader: counts as leader contact for
        # lease-mode vote stickiness (it does NOT reset the election timer —
        # heartbeats own liveness detection, exactly as in the seed).
        self._note_leader_contact(now)
        window = msg.window if msg.window else (
            (msg.entry,) if msg.entry is not None else ()
        )
        for off, entry in enumerate(window):
            index = msg.index + off
            if index <= self.snapshot_last_index:
                continue  # already compacted == committed
            if self.slot(index) is None and not self._seen(entry.entry_id):
                # Leader's finalize overrides any conflicting tentative entry.
                self.fast_slots[index] = Slot(entry.clone(), SlotState.FINALIZED)
        self._merge_finalized(now)
        if msg.leader_commit > self.commit_index:
            self._advance_commit(msg.leader_commit, now)
        return []

    def _merge_finalized(self, now: float) -> None:
        """Fold contiguous FINALIZED overlay slots into the authoritative log
        and (leader only) commit them — a contiguous ceil(3M/4) fast quorum
        IS commit."""
        merged_any = False
        while True:
            nxt = self.last_log_index() + 1
            s = self.fast_slots.get(nxt)
            if s is None or s.state is not SlotState.FINALIZED:
                break
            del self.fast_slots[nxt]
            self._finalized_held.pop(nxt, None)
            if self._seen(s.entry.entry_id):
                continue  # already classicized elsewhere in the log
            self._append_slot(s)
            merged_any = True
        if merged_any and self.role is Role.LEADER:
            self._advance_commit(self._highest_contiguous_finalized(), now)

    def _highest_contiguous_finalized(self) -> int:
        i = self.commit_index
        while i < self.last_log_index():
            if self.slot(i + 1).state is SlotState.FINALIZED:
                i += 1
            else:
                break
        return i

    # --------------------------------------------------------------- ticks

    def _flush_acks(self) -> None:
        # Buffered FastVotes leave first (they were cast before any
        # AppendEntries ack buffered later the same tick could matter),
        # stamped with the term they were cast in; then the base class
        # flushes AppendEntries acks and clears the shared buffer clock.
        if self._vote_buf:
            for dst, votes in self._vote_buf.items():
                head_index, head_eid = votes[0]
                self._outbox.append(
                    (
                        dst,
                        FastVote(
                            term=self._vote_buf_term,
                            src=self.id,
                            index=head_index,
                            entry_id=head_eid,
                            voter=self.id,
                            multi_votes=tuple(votes[1:]),
                        ),
                    )
                )
                if len(votes) > 1:
                    self._count("fast_votes_folded", len(votes) - 1)
            self._vote_buf = {}
        super()._flush_acks()

    def _protocol_idle(self) -> bool:
        # _tick_protocol below is a no-op exactly when there are no leader
        # tallies, no held finalizations, and no proposer inflight state.
        return (
            not self.inflight
            and not self.tallies
            and not self._finalized_held
        )

    def _tick_protocol(self, now: float) -> Outputs:
        out: Outputs = []
        timeout = self.config.fast_vote_timeout
        if self.role is Role.LEADER:
            for index, tally in list(self.tallies.items()):
                if not tally.resolved and now - tally.first_vote_at > timeout:
                    out += self._fallback_slot(index, now)
            # Liveness for held finalized slots whose gap never fills:
            # re-route them through the classic track in index order.
            stuck = sorted(i for i, t in self._finalized_held.items()
                           if now - t > timeout)
            for index in stuck:
                s = self.fast_slots.pop(index, None)
                self._finalized_held.pop(index, None)
                if s is not None and not self._seen(s.entry.entry_id):
                    self._count("fast_held_reroutes")
                    out += super()._leader_append(s.entry.command,
                                                  s.entry.entry_id, now)
        # Proposer retry: inflight proposals that never committed fall back
        # through the classic forward path.
        for eid, prop in list(self.inflight.items()):
            if self._seen(eid):
                del self.inflight[eid]
                continue
            if not prop.fell_back and now - prop.started_at > timeout:
                prop.fell_back = True
                if self.metrics is not None:
                    self.metrics.fell_back(eid, now)
                if self.leader_id is not None and self.leader_id != self.id:
                    out.append(
                        (
                            self.leader_id,
                            ForwardOperation(term=self.term, src=self.id,
                                             command=prop.command, entry_id=eid),
                        )
                    )
                elif self.role is Role.LEADER:
                    out += super()._leader_append(prop.command, eid, now)
            elif prop.fell_back and now - prop.started_at > 6 * timeout:
                del self.inflight[eid]  # give up; client-level retry
        return out

    # ----------------------------------------------- election & recovery

    def _tentative_tail(self) -> Optional[dict]:
        return {
            i: (s.entry.clone(), s.state.value) for i, s in self.fast_slots.items()
        }

    def _on_leadership_acquired(self, now: float) -> Outputs:
        """Recover possibly-fast-committed entries from the election quorum.

        Must-adopt entries are re-adopted at their ORIGINAL slot index,
        overwriting uncommitted classic entries if present (a committed
        conflicting classic entry at the same index is impossible — see
        module docstring). The must threshold is config-aware: an entry
        that fast-committed holds >= fq(V) of every active voter set V, so
        within the granted sample S_V (of V's voters) it appears at least
        fq(V) + |S_V| - |V| times; an entry below that bound in ANY active
        set provably did not fast-commit. During a joint config this is
        evaluated against both halves — conservative in the safe direction
        (over-adopting a non-committed entry just re-proposes it
        classically; EntryId dedup keeps that idempotent). Gaps below a
        must-adopt index that cannot be filled prove the entry never
        committed, so it is appended at the next free index instead.
        """
        granted: Dict[NodeId, dict] = {
            n: (r.tentative_tail or {})
            for n, r in self.votes_received.items()
            if r.vote_granted
        }

        holders: Dict[int, Dict[EntryId, set]] = {}
        entries: Dict[EntryId, Entry] = {}
        for src, tail in granted.items():
            for index, (entry, _state) in tail.items():
                holders.setdefault(index, {}).setdefault(entry.entry_id, set()).add(src)
                entries.setdefault(entry.entry_id, entry)

        def may_have_fast_committed(holder_set: set) -> bool:
            for vs in self.cluster_config.voter_sets():
                s = set(vs)
                sample = sum(1 for n in granted if n in s)
                thr = max(1, fast_quorum(len(s)) + sample - len(s))
                if len(holder_set & s) < thr:
                    return False
            return True

        must: List[Tuple[int, EntryId]] = []
        maybe: List[EntryId] = []
        for index in sorted(holders):
            ranked = sorted(
                holders[index].items(), key=lambda kv: (-len(kv[1]), str(kv[0]))
            )
            top_eid, top_holders = ranked[0]
            if may_have_fast_committed(top_holders):
                must.append((index, top_eid))
                ranked = ranked[1:]
            if self.readopt_uncommitted:
                maybe.extend(eid for eid, _ in ranked)

        displaced: List[Entry] = []
        for index, eid in must:
            e = entries[eid]
            if self._seen(eid):
                continue
            if index <= self.snapshot_last_index:
                # The slot is compacted committed history holding a different
                # entry — a conflicting fast commit there is impossible, so
                # this candidate provably never committed. Re-append it at a
                # fresh index for liveness.
                displaced.append(e)
                continue
            if index <= self.last_log_index():
                cur = self.slot(index)
                if cur.entry.same_entry(e):
                    continue
                # Overwrite an uncommitted classic entry at the original slot.
                assert index > self.commit_index, "would overwrite a committed slot"
                displaced.extend(
                    s.entry for s in self.log[index - 1 :]
                    if s.state is SlotState.CLASSIC
                )
                self._truncate_from(index)
            # Append at original index when contiguous; otherwise the gap
            # proves non-commitment and next-free-index placement is safe.
            e2 = Entry(term=self.term, command=e.command, entry_id=eid,
                       proposed_at=e.proposed_at)
            self._append_slot(Slot(e2, SlotState.CLASSIC))
            self._count("recovered_fast_entries")

        out: Outputs = []
        for e in displaced:
            if not self._seen(e.entry_id):
                out += super()._leader_append(e.command, e.entry_id, now)
        if self.readopt_uncommitted:
            for eid in maybe:
                if not self._seen(eid):
                    e = entries[eid]
                    out += super()._leader_append(e.command, eid, now)
        # The new leader's log is now authoritative; clear the overlay and
        # stale tallies from previous terms.
        self.fast_slots.clear()
        self.tallies.clear()
        self._finalized_held.clear()
        self._count("recoveries")
        return out

    def _on_leadership_lost(self, now: float) -> None:
        """Step-down (higher term, CheckQuorum, removal from config): drop
        every leader-volatile piece of fast-track state. Tallies and held
        finalized slots are THIS leadership's vote accounting — a later
        re-election must rebuild them from vote replies (_recover), not
        trust counts from before the step-down. fast_slots stay: a
        tentative slot is this node's durable FCFS vote as an ACCEPTOR,
        which survives role changes by design."""
        self.tallies.clear()
        self._finalized_held.clear()
        self._finalize_accum = None

    # ------------------------------------------------- linearizable reads

    def _read_index(self) -> int:
        """Read-visibility rule under the fast track (module docstring):
        every fast-acked write is covered by commit_index before its
        FastFinalize broadcast leaves, because _merge_finalized commits and
        applies synchronously inside the vote handler. Held finalized slots
        above the contiguous prefix were never acked, so excluding them is
        exactly right — the base rule needs no widening."""
        return self.commit_index

    # ------------------------------------------- classic-track interactions

    def _handle_AppendEntriesArgs(self, msg: AppendEntriesArgs, now: float) -> Outputs:
        out = super()._handle_AppendEntriesArgs(msg, now)
        # Reconcile the overlay with newly-arrived authoritative entries:
        # overlay slots at indexes the log now owns are dead (the classic
        # track won); displaced inflight proposals re-route via timeout.
        for index in list(self.fast_slots.keys()):
            if index <= self.last_log_index():
                del self.fast_slots[index]
                self._finalized_held.pop(index, None)
        self._merge_finalized(now)
        return out

    def _install_snapshot(self, snap, now: float) -> None:
        super()._install_snapshot(snap, now)
        # Overlay reservations at compacted indexes are dead: those slots
        # are committed history now. Displaced proposals re-route via the
        # inflight timeout (dedup by entry_id keeps this idempotent).
        for index in list(self.fast_slots.keys()):
            if index <= self.snapshot_last_index:
                del self.fast_slots[index]
                self._finalized_held.pop(index, None)
                self.tallies.pop(index, None)
        self._merge_finalized(now)

    def restart(self, now: float) -> None:
        # fast_slots (and the durable votes they imply) persist across
        # crashes; leader tallies and proposer inflight state are volatile.
        super().restart(now)
        self.tallies = {}
        self.inflight = {}
        self._finalized_held = {}
        self._finalize_accum = None
        self._vote_buf = {}
