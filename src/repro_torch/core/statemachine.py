"""Pluggable replicated state machines for the consensus core.

The seed's "state machine" was literally the committed command list, so
snapshots carried every entry ever applied and compaction saved nothing on
the wire. This module makes the applied state a first-class, swappable
object (see DESIGN.md):

- :class:`StateMachine` — the protocol a machine implements:
  ``apply(index, entry)``, ``snapshot() -> state``, ``restore(state)``,
  ``size_bytes()``. Snapshot state must be JSON-serializable (it is what
  :class:`repro_torch.checkpoint.manager.SnapshotStore` persists and what chunked
  InstallSnapshot streams over the wire).
- :class:`LogListMachine` — the default; reproduces the seed semantics
  bit-for-bit: state is the applied entry list, ``committed_entries()`` /
  ``committed_commands()`` keep returning the full history, and snapshots
  remain O(history).
- :class:`KVMachine` — a real key-value workload (SET / GET / DEL / CAS
  with per-key versioning) whose snapshot is the live key map: O(live
  keys), not O(history) — the reduced-state snapshot the paper's evaluation
  as a replication substrate assumes.
- :class:`DedupTable` — compact exactly-once filter over applied EntryIds.
  The log keeps per-entry ids only while entries are live; once the prefix
  compacts into an opaque snapshot, client-retry dedup needs a membership
  oracle that does not grow with history. Per-origin ``(max_seq, holes)``
  is exact (a hole is a seq below the watermark that never applied, e.g. a
  command that fast-committed out of order) and O(clients + holes).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

from repro_torch.core.types import Entry, EntryId, entry_from_wire, entry_to_wire

# Rough per-entry bookkeeping overhead (term, id, framing) used by
# size_bytes() accounting; only relative sizes matter to the simulator.
_ENTRY_OVERHEAD = 24
_KEY_OVERHEAD = 16


class StateMachine:
    """Protocol for the replicated state machine a RaftNode drives.

    Contract (see DESIGN.md for the full argument):

    - ``apply(index, entry)`` is called exactly once per committed index in
      index order during normal operation. After a crash-restart the node
      rolls the machine back to its last snapshot (``restore``) and
      re-applies the suffix, so a machine never needs its own durability.
    - ``snapshot()`` returns a JSON-serializable value capturing the state
      as of the last applied entry. It must not alias mutable internals:
      later ``apply`` calls must not change an already-taken snapshot.
    - ``restore(state)`` replaces the machine's state with a previously
      taken snapshot; ``restore(None)`` resets to the empty initial state.
    - ``size_bytes()`` is the approximate serialized size of the CURRENT
      state — what a snapshot of it would cost on the wire.
    """

    name = "base"

    def apply(self, index: int, entry: Entry) -> Any:
        raise NotImplementedError

    def snapshot(self) -> Any:
        raise NotImplementedError

    def restore(self, state: Any) -> None:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def query(self, query: Any) -> Any:
        """Read-only entry point for the linearizable read path.

        MUST NOT mutate state and is never dedup-recorded — unlike
        ``apply``, a query is not a log entry: it has no index, is not
        replicated, and may be evaluated any number of times (origin-side
        read retries re-evaluate at the then-current applied state).
        Machines that don't support reads return None.
        """
        return None

    def applied_entries(self) -> Optional[List[Entry]]:
        """Full applied entry history, when the machine retains it.

        The LogListMachine does (that IS its state); reduced-state machines
        return None, and ``RaftNode.committed_entries`` then only exposes
        the uncompacted tail.
        """
        return None

    # -- delta snapshots (RaftConfig.delta_snapshots) ----------------------

    def snapshot_delta(self, base_state: Any, target_state: Any) -> Optional[Any]:
        """JSON-serializable delta transforming ``base_state`` (an earlier
        ``snapshot()`` result) into ``target_state`` (a later one), or None
        when the machine cannot beat a full transfer. The default — kept by
        LogListMachine, whose state IS the history — is None, which makes
        the leader fall back to streaming the full snapshot."""
        return None

    def apply_delta(self, base_state: Any, delta: Any) -> Any:
        """Reconstruct the target snapshot state from ``base_state`` plus a
        ``snapshot_delta``-produced delta. Must not mutate ``base_state``
        (it is the receiver's live snapshot)."""
        raise NotImplementedError


class LogListMachine(StateMachine):
    """Seed-compatible machine: the state is the applied entry sequence.

    Keeps ``committed_entries()`` exact across compaction (the snapshot
    carries every applied entry), which is what the history-based test
    checkers rely on. Snapshots are O(history) by design — this machine
    exists to reproduce the seed's semantics, not to save bytes.
    """

    name = "loglist"

    def __init__(self) -> None:
        self._entries: List[Entry] = []
        self._bytes = 0

    def apply(self, index: int, entry: Entry) -> Any:
        self._entries.append(entry.clone())
        self._bytes += _ENTRY_OVERHEAD + len(str(entry.command))
        return None

    def snapshot(self) -> Any:
        return [entry_to_wire(e) for e in self._entries]

    def restore(self, state: Any) -> None:
        self._entries = (
            [] if state is None else [entry_from_wire(d) for d in state]
        )
        self._bytes = sum(
            _ENTRY_OVERHEAD + len(str(e.command)) for e in self._entries
        )

    def size_bytes(self) -> int:
        return self._bytes

    def query(self, query: Any) -> Any:
        if query == "LEN":
            return len(self._entries)
        if query == "LAST":
            return self._entries[-1].command if self._entries else None
        return None

    def applied_entries(self) -> Optional[List[Entry]]:
        return list(self._entries)


class KVMachine(StateMachine):
    """Key-value machine: SET / GET / DEL / CAS with per-key versioning.

    Commands are whitespace-separated strings::

        SET <key> <value...>        write; bumps the key's version
        GET <key>                   read (returns the value, state unchanged)
        DEL <key>                   remove the key
        CAS <key> <expected> <new...>   write iff current value == expected

    Anything else (membership ``__config__:`` commands, hierarchy shadow
    entries, checkpoint records, plain strings) is a no-op — infrastructure
    commands flow through the same log and must not wedge the machine.

    The snapshot is the live key map ``{key: [value, version]}``: O(live
    keys) regardless of how many updates the history contains.
    """

    name = "kv"

    def __init__(self) -> None:
        self._kv: Dict[str, List] = {}  # key -> [value, version]
        self._bytes = 0

    # -- command interpreter ------------------------------------------------

    def apply(self, index: int, entry: Entry) -> Any:
        cmd = entry.command
        if not isinstance(cmd, str):
            return None
        parts = cmd.split(" ")
        op = parts[0]
        if op == "SET" and len(parts) >= 3:
            return self._write(parts[1], " ".join(parts[2:]))
        if op == "GET" and len(parts) == 2:
            cur = self._kv.get(parts[1])
            return cur[0] if cur is not None else None
        if op == "DEL" and len(parts) == 2:
            cur = self._kv.pop(parts[1], None)
            if cur is not None:
                self._bytes -= _KEY_OVERHEAD + len(parts[1]) + len(str(cur[0]))
            return cur is not None
        if op == "CAS" and len(parts) >= 4:
            key, expected = parts[1], parts[2]
            cur = self._kv.get(key)
            if cur is not None and cur[0] == expected:
                self._write(key, " ".join(parts[3:]))
                return True
            return False
        return None

    def _write(self, key: str, value: str) -> int:
        cur = self._kv.get(key)
        if cur is None:
            self._kv[key] = [value, 1]
            self._bytes += _KEY_OVERHEAD + len(key) + len(value)
            return 1
        self._bytes += len(value) - len(str(cur[0]))
        cur[0] = value
        cur[1] += 1
        return cur[1]

    # -- snapshot protocol --------------------------------------------------

    def snapshot(self) -> Any:
        return {k: list(v) for k, v in self._kv.items()}

    def restore(self, state: Any) -> None:
        self._kv = {} if state is None else {k: list(v) for k, v in state.items()}
        self._bytes = sum(
            _KEY_OVERHEAD + len(k) + len(str(v[0])) for k, v in self._kv.items()
        )

    def size_bytes(self) -> int:
        return self._bytes

    # -- delta snapshots ----------------------------------------------------

    def snapshot_delta(self, base_state: Any, target_state: Any) -> Optional[Any]:
        """O(live keys) delta: per-key versions make change detection a
        single integer compare per key (a same-value CAS still bumps the
        version, so every write is caught). Shape:
        ``{"set": {key: [value, version]}, "del": [keys]}``."""
        if not isinstance(base_state, dict) or not isinstance(target_state, dict):
            return None
        set_ops: Dict[str, List] = {}
        for k, v in target_state.items():
            b = base_state.get(k)
            if b is None or b[1] != v[1] or b[0] != v[0]:
                set_ops[k] = list(v)
        deleted = sorted(k for k in base_state if k not in target_state)
        return {"set": set_ops, "del": deleted}

    def apply_delta(self, base_state: Any, delta: Any) -> Any:
        state = (
            {}
            if base_state is None
            else {k: list(v) for k, v in base_state.items()}
        )
        for k in delta.get("del", ()):
            state.pop(k, None)
        for k, v in delta.get("set", {}).items():
            state[k] = list(v)
        return state

    # -- read-only query path (linearizable reads) -------------------------

    def query(self, query: Any) -> Any:
        """GET/VERSION/KEYS without going through the log. Same command
        grammar as ``apply`` where it overlaps (``GET <key>``) so a workload
        can switch a GET between the log path and the read path without
        rewriting commands. Never mutates ``self._kv``."""
        if not isinstance(query, str):
            return None
        parts = query.split(" ")
        if parts[0] == "GET" and len(parts) == 2:
            cur = self._kv.get(parts[1])
            return cur[0] if cur is not None else None
        if parts[0] == "VERSION" and len(parts) == 2:
            cur = self._kv.get(parts[1])
            return cur[1] if cur is not None else 0
        if parts[0] == "KEYS" and len(parts) == 1:
            return sorted(self._kv)
        return None

    # -- queries (tests / benchmarks) --------------------------------------

    def get(self, key: str) -> Optional[str]:
        cur = self._kv.get(key)
        return cur[0] if cur is not None else None

    def version(self, key: str) -> int:
        cur = self._kv.get(key)
        return cur[1] if cur is not None else 0

    def keys(self) -> List[str]:
        return sorted(self._kv)


class DedupTable:
    """Exactly-once membership oracle over applied EntryIds, O(clients).

    Per origin we keep the highest applied seq (``max``) plus the set of
    ``holes``: seqs at or below the watermark that have NOT applied (fast
    track and leader recovery can commit a client's seqs out of order).
    ``contains`` is exact: seq <= max and not a hole.
    """

    def __init__(self) -> None:
        self._max: Dict[str, int] = {}
        self._holes: Dict[str, Set[int]] = {}

    def add(self, entry_id: EntryId) -> None:
        origin, seq = entry_id.origin, entry_id.seq
        hi = self._max.get(origin, 0)
        if seq > hi:
            if seq > hi + 1:
                self._holes.setdefault(origin, set()).update(range(hi + 1, seq))
            self._max[origin] = seq
        else:
            holes = self._holes.get(origin)
            if holes is not None:
                holes.discard(seq)
                if not holes:
                    del self._holes[origin]

    def contains(self, entry_id: EntryId) -> bool:
        origin, seq = entry_id.origin, entry_id.seq
        if seq > self._max.get(origin, 0):
            return False
        return seq not in self._holes.get(origin, ())

    def max_seq(self, origin: str) -> int:
        return self._max.get(origin, 0)

    # -- snapshot wire format ----------------------------------------------

    def state(self) -> Dict[str, Any]:
        return {
            "max": dict(self._max),
            "holes": {o: sorted(s) for o, s in self._holes.items() if s},
        }

    @classmethod
    def from_state(cls, state: Any) -> "DedupTable":
        t = cls()
        if state:
            t._max = {o: int(v) for o, v in state.get("max", {}).items()}
            t._holes = {
                o: set(v) for o, v in state.get("holes", {}).items() if v
            }
        return t
