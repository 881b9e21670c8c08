"""Protocol fuzzer: a seeded, deterministic adversary that mints regression
tests.

The chaos suite exercises failure scenarios we thought of; this module
explores the ones we didn't. A :class:`ProtocolFuzzer` drives a live
:class:`repro_torch.core.sim.Cluster` through a seeded random schedule of
partitions, crashes, restarts (warm and from the persisted checkpoint
store), clock skew, message drop/duplication/corruption windows
(:class:`repro_torch.core.sim.Adversary`), membership churn, and client
writes/reads — and checks the FULL oracle suite from
``tests/commit_history.py`` after every single step:

  agreement · no-duplicates · durability of acked commits · per-client FIFO
  (single-batch origins) · read freshness/validity · joint-config
  discipline · election safety (plus the Recorder's online commit/election
  safety asserts, which fire mid-run).

Everything is deterministic per seed: ops are generated up front from one
``random.Random(seed)`` with every target resolved to a concrete node name,
so the trace needs no RNG to replay — same seed ⇒ identical trace ⇒
identical verdict. A failing schedule is shrunk (ddmin-style chunk removal)
to a minimal op list and saved as a JSON trace file; any trace file replays
standalone via :func:`replay_trace_file` — the one-liner a regression test
needs (see ``tests/regressions/``).

Trace file format (version 1)::

    {
      "version": 1,
      "seed":    <int>,                 # provenance only; replay is RNG-free
      "profile": { ...FuzzProfile... },
      "ops":     [ {"op": "...", ...}, ... ],
      "expect":  {                      # all optional; checked after recovery
        "require_leader":       true,
        "max_leader_elections": <int>,  # total leaderships ever elected
        "max_term":             <int>,  # highest term any node reached
        "min_commits":          <int>,  # committed entries cluster-wide
        "min_counters":         {"adv_corrupted": 1, ...},  # scenario proof
        "max_counters":         {"checkquorum_stepdowns": 0, ...}
      }
    }

CLI (the CI fuzz lane)::

    PYTHONPATH=src python -m repro_torch.core.fuzzer --seeds 1-20 --steps 40 \
        --out artifacts/fuzz [--no-shrink]

exits non-zero if any seed fails, writing the shrunk failing trace to the
out directory — the workflow uploads it as an artifact, and promoting it to
a named regression test is one ``cp`` into ``tests/regressions/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import tempfile
import traceback
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.manager import SnapshotStore
from repro_torch.core.raft import RaftConfig
from repro_torch.core.sim import Adversary, Cluster, FailureProfile
from repro_torch.core.statemachine import KVMachine
from repro_torch.core.types import EntryId

TRACE_VERSION = 1


def preset_failure_profiles(
    name: str, nodes: List[str]
) -> Dict[str, FailureProfile]:
    """Named per-node FailureProfile presets for fuzz sweeps, a pure
    function of (name, node order) so a trace that records only the
    preset name replays against the identical fleet.

    - "crashy":      staggered crash/recover renewal on every node, two
                     correlated-failure groups (the nightly crash-heavy
                     lane);
    - "slow-cpu":    a minority of nodes applies 10-40 ms behind commit;
    - "flaky-links": asymmetric per-node loss/latency multipliers (loss
                     multipliers only bite when the base network is lossy);
    - "mixed":       all three at once, milder.
    """
    out: Dict[str, FailureProfile] = {}
    if name == "crashy":
        for i, nid in enumerate(nodes):
            out[nid] = FailureProfile(
                mtbf_ms=3000.0 + 1100.0 * i,
                mttr_ms=400.0 + 170.0 * i,
                group=f"g{i % 2}",
            )
    elif name == "slow-cpu":
        for i, nid in enumerate(nodes):
            if i % 3 == 0:
                out[nid] = FailureProfile(apply_lag_ms=10.0 + 10.0 * (i % 4))
    elif name == "flaky-links":
        for i, nid in enumerate(nodes):
            out[nid] = FailureProfile(
                loss_mult=1.0 + 0.8 * (i % 3),
                latency_mult=1.0 + 0.5 * (i % 4),
                in_loss_mult=1.0 + 0.4 * ((i + 1) % 3),
                in_latency_mult=1.0 + 0.25 * ((i + 2) % 4),
            )
    elif name == "mixed":
        for i, nid in enumerate(nodes):
            out[nid] = FailureProfile(
                mtbf_ms=6000.0 + 1300.0 * i,
                mttr_ms=500.0,
                apply_lag_ms=8.0 if i % 2 else 0.0,
                latency_mult=1.0 + 0.3 * (i % 3),
                group=f"g{i % 2}",
            )
    elif name:
        raise ValueError(f"unknown failure profile preset {name!r}")
    return out


# Named (bytes_per_ms, mtu_bytes) link presets for the --link-profile CLI.
# Pure data: the chosen numbers are serialized into the trace profile, so a
# replay needs no preset lookup. "thin" is a serialization-limited pipe
# where appends and snapshot chunks queue behind each other; "congested"
# crawls AND fragments (per-packet loss bites big messages hardest);
# "mtu-lossy" keeps infinite rate but makes loss size-aware.
LINK_PROFILES: Dict[str, Tuple[float, float]] = {
    "": (0.0, 0.0),
    "thin": (60.0, 1400.0),
    "congested": (25.0, 512.0),
    "mtu-lossy": (0.0, 256.0),
}


@dataclasses.dataclass
class FuzzProfile:
    """Cluster shape + protocol knobs a trace runs against. Serialized into
    every trace file so a regression replays against the exact
    configuration that failed, not today's defaults."""

    n: int = 5
    protocol: str = "fastraft"
    pre_vote: bool = True
    check_quorum: bool = True
    lease_duration_ms: float = 120.0
    clock_skew_ms: float = 20.0
    clock_drift: float = 0.0001
    election_timeout_min: float = 150.0
    election_timeout_max: float = 300.0
    heartbeat_interval: float = 50.0
    snapshot_threshold: int = 12
    snapshot_chunk_bytes: int = 96
    snapshot_chunk_window: int = 2
    loss: float = 0.0
    jitter: float = 1.0
    # Read-path knobs. BOTH must default to the pre-replica-read behavior
    # (0.0 / False): from_dict fills missing keys with these defaults, so
    # regression traces minted before the knobs existed must replay against
    # the schedule they failed under, not today's.
    read_coalesce_window: float = 0.0
    election_noop: bool = False
    # Reliability knobs — same backward-compat rule: "" / 0 reproduce the
    # pre-knob schedules exactly. ``failure_profile`` names a preset from
    # :func:`preset_failure_profiles` installed at cluster construction
    # (crash/recover renewal chaos on top of the op schedule);
    # ``witnesses`` marks the LAST w founding nodes as quorum-only
    # witness members.
    failure_profile: str = ""
    witnesses: int = 0
    # Link-capacity knobs (bandwidth-constrained fuzzing). 0.0 = infinite
    # capacity, the schedule every pre-link trace was minted under.
    # ``bytes_per_ms`` gives each directed link a serial transmit rate
    # (messages queue FIFO behind each other); ``mtu_bytes`` makes loss
    # per-packet, so big messages die more often than small ones.
    bytes_per_ms: float = 0.0
    mtu_bytes: float = 0.0
    # Wire-efficiency knobs (DESIGN.md section 13) — defaults off so
    # pre-knob traces replay byte-identically.
    delta_snapshots: bool = False
    ack_piggyback: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FuzzProfile":
        fields = {f.name for f in dataclasses.fields(FuzzProfile)}
        return FuzzProfile(**{k: v for k, v in d.items() if k in fields})

    def raft_config(self) -> RaftConfig:
        return RaftConfig(
            election_timeout_min=self.election_timeout_min,
            election_timeout_max=self.election_timeout_max,
            heartbeat_interval=self.heartbeat_interval,
            pre_vote=self.pre_vote,
            check_quorum=self.check_quorum,
            lease_duration_ms=self.lease_duration_ms,
            clock_skew_ms=self.clock_skew_ms,
            snapshot_threshold=self.snapshot_threshold,
            snapshot_chunk_bytes=self.snapshot_chunk_bytes,
            snapshot_chunk_window=self.snapshot_chunk_window,
            read_coalesce_window=self.read_coalesce_window,
            election_noop=self.election_noop,
            delta_snapshots=self.delta_snapshots,
            ack_piggyback=self.ack_piggyback,
        )


@dataclasses.dataclass
class FuzzReport:
    ok: bool
    error: str = ""
    failed_at_step: int = -1  # index into ops; -1 = setup/expect phase
    n_ops: int = 0
    n_commits: int = 0
    n_reads_checked: int = 0
    leader_elections: int = 0
    max_term: int = 0
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def make_trace(
    seed: int,
    ops: List[Dict[str, Any]],
    profile: Optional[FuzzProfile] = None,
    expect: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    return {
        "version": TRACE_VERSION,
        "seed": seed,
        "profile": (profile or FuzzProfile()).to_dict(),
        "ops": ops,
        "expect": expect or {},
    }


def save_trace(trace: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        trace = json.load(f)
    assert trace.get("version") == TRACE_VERSION, (
        f"unknown trace version {trace.get('version')!r} in {path}"
    )
    return trace


def replay_trace_file(path: str, engine: str = "slotted") -> FuzzReport:
    """THE regression entry point: replay a saved trace standalone.

    ``engine`` selects the simulator event engine ("slotted" or "legacy");
    both produce byte-identical schedules, so a trace minted under either
    replays identically under the other (tests/test_sim_equivalence.py
    gates this)."""
    return replay(load_trace(path), engine=engine)


# ---------------------------------------------------------------- replayer


class _TraceRunner:
    """Applies one trace's ops to a live cluster, oracle-checking after
    every step. Tolerant of structurally-invalid ops (unknown node, double
    crash): shrinking removes ops arbitrarily, and only ORACLE failures may
    count as failures — never bookkeeping artifacts of the shrink itself."""

    def __init__(self, trace: Dict[str, Any], store_dir: str, engine: str = "slotted"):
        self.profile = FuzzProfile.from_dict(trace.get("profile", {}))
        self.expect = trace.get("expect", {}) or {}
        self.store = SnapshotStore(store_dir)
        p = self.profile
        wits = [f"n{i}" for i in range(p.n - p.witnesses, p.n)] if p.witnesses else []
        self.cluster = Cluster(
            n=p.n,
            protocol=p.protocol,
            seed=trace.get("seed", 0),
            loss=p.loss,
            jitter=p.jitter,
            config=p.raft_config(),
            snapshot_store=self.store,
            state_machine_factory=lambda nid: KVMachine(),
            clock_skew_ms=p.clock_skew_ms,
            clock_drift=p.clock_drift,
            engine=engine,
            witnesses=wits,
            bytes_per_ms=p.bytes_per_ms,
            mtu_bytes=p.mtu_bytes,
        )
        if p.failure_profile:
            self.cluster.set_failure_profiles(
                preset_failure_profiles(
                    p.failure_profile, [f"n{i}" for i in range(p.n)]
                )
            )
        self.writes: List[Tuple[EntryId, str]] = []  # every KV write submitted
        self.submit_batches: Dict[str, int] = {}  # origin -> batch count
        self.n_reads_checked = 0

    # -- op execution ------------------------------------------------------

    def apply_op(self, op: Dict[str, Any]) -> None:
        c = self.cluster
        kind = op.get("op")
        if kind == "run":
            c.run(float(op.get("ms", 500.0)))
        elif kind == "partition":
            groups = [
                [n for n in g if n in c.nodes] for g in op.get("groups", [])
            ]
            groups = [g for g in groups if g]
            if len(groups) >= 2:
                c.partition(*groups)
        elif kind == "heal":
            c.heal()
        elif kind == "crash":
            node = c.nodes.get(op.get("node"))
            if node is not None:
                node.crash()
        elif kind == "restart":
            node = c.nodes.get(op.get("node"))
            if node is not None:
                node.restart(c.sim.now)
        elif kind == "restart_from_store":
            if op.get("node") in c.nodes:
                c.restart_from_store(op["node"], seed=int(op.get("seed", 1)))
        elif kind == "clock_skew":
            node = c.nodes.get(op.get("node"))
            if node is not None:
                # Clamp inside the configured safety margin: skew beyond
                # clock_skew_ms makes stale lease reads a CONFIG error, not
                # a protocol bug — the fuzzer only probes the promised
                # envelope.
                m = self.profile.clock_skew_ms
                node.clock_offset = max(-m, min(m, float(op.get("offset_ms", 0.0))))
        elif kind == "adversary":
            c.adversary = Adversary(
                seed=int(op.get("seed", 0)),
                drop_p=float(op.get("drop", 0.0)),
                dup_p=float(op.get("dup", 0.0)),
                corrupt_p=float(op.get("corrupt", 0.0)),
                until=c.sim.now + float(op.get("ms", 1000.0)),
            )
        elif kind == "adversary_off":
            c.adversary = None
        elif kind == "failure_profiles":
            # Install a named preset over the CURRENT membership (or lift
            # all profiles with preset "").
            preset = op.get("preset", "")
            if preset:
                c.set_failure_profiles(
                    preset_failure_profiles(preset, sorted(c.nodes))
                )
            else:
                c.clear_failure_profiles()
        elif kind == "crash_group":
            c.crash_group(op.get("group", ""))
        elif kind == "submit":
            via = op.get("via")
            if via in c.nodes and c.nodes[via].alive:
                cmds = [
                    f"SET {key} {val}"
                    for key, val in zip(op.get("keys", []), op.get("vals", []))
                ]
                if cmds:
                    eids = c.submit_batch(cmds, via=via)
                    self.writes.extend(zip(eids, cmds))
                    self.submit_batches[via] = self.submit_batches.get(via, 0) + 1
        elif kind == "read":
            via = op.get("via")
            if via in c.nodes and c.nodes[via].alive:
                # Three flavors, all oracle-checked: "leader" (ReadIndex /
                # lease; also every pre-replica-read trace, which carries
                # no mode key), "replica" (watermark-linearizable at via),
                # "stale" (replica with an explicit staleness bound).
                mode = op.get("mode", "leader")
                staleness = 0.0
                if mode == "stale":
                    mode = "replica"
                    staleness = float(op.get("staleness_ms", 500.0))
                c.read(
                    f"GET {op.get('key', 'k0')}", via=via,
                    mode=mode, max_staleness_ms=staleness,
                )
        elif kind == "membership":
            self._apply_membership(op)
        # Unknown kinds are ignored (forward compatibility + shrink safety).

    def _apply_membership(self, op: Dict[str, Any]) -> None:
        c = self.cluster
        mk = op.get("kind")
        timeout = float(op.get("timeout", 60_000.0))
        try:
            if mk == "remove" and op.get("node") in c.nodes:
                c.remove_node(op["node"], timeout=timeout)
            elif mk == "add" and op.get("node") not in c.nodes:
                c.add_learner(op["node"], timeout=timeout)
                c.promote(op["node"], timeout=timeout)
            elif mk == "replace" and op.get("node") in c.nodes:
                if op.get("new") not in c.nodes:
                    c.replace_node(op["node"], op["new"], timeout=timeout)
        except AssertionError:
            raise
        except Exception:
            pass  # structurally impossible op after shrinking: skip

    # -- oracles -----------------------------------------------------------

    def check_oracles(self, final: bool = False) -> None:
        # Imported lazily: tests/ is importable because conftest puts the
        # repo root on sys.path for pytest, and the CLI below mirrors that.
        from tests.commit_history import (
            check_commit_history,
            check_config_oracle,
            check_kv_consistency,
            check_read_oracle,
            committed_acks,
        )

        c = self.cluster
        # Acked-durability is asserted only on the FINAL settled pass:
        # restarting a quorum rolls volatile commit_index back until the
        # leader re-advances it, so mid-step the entry is safe in every log
        # yet enumerable on no node — a timing artifact, not a loss. A real
        # loss cannot heal, so the final pass still catches it.
        acked = (
            committed_acks(c, [e for e, _ in self.writes]) if final else []
        )
        # Per-client FIFO is promised for SEQUENTIAL submitters. Claim it
        # for origins that (a) submitted exactly one batch and (b) had no
        # fast-track fallback: losing a contested slot re-proposes the
        # entry through the leader, legitimately reordering it relative to
        # window-mates that won their slots.
        fifo = []
        for origin, batches in self.submit_batches.items():
            if batches != 1:
                continue
            eids = [e for e, _ in self.writes if e.origin == origin]
            if all(
                c.metrics.traces[e].fallbacks == 0
                for e in eids
                if e in c.metrics.traces
            ):
                fifo.append(origin)
        check_commit_history(c, acked=acked, fifo_origins=fifo)
        check_kv_consistency(c)
        check_config_oracle(c)
        self.n_reads_checked = check_read_oracle(c, self.writes)

    def check_expectations(self) -> None:
        c = self.cluster
        exp = self.expect
        if exp.get("require_leader"):
            assert c.leader() is not None, "no leader after recovery"
        elections = sum(len(s) for s in c.metrics.leaders.values())
        if "max_leader_elections" in exp:
            assert elections <= exp["max_leader_elections"], (
                f"{elections} leaderships elected "
                f"(expected <= {exp['max_leader_elections']}): "
                f"{dict(sorted(c.metrics.leaders.items()))}"
            )
        if "max_term" in exp:
            hi = max(n.term for n in c.nodes.values())
            assert hi <= exp["max_term"], (
                f"term inflated to {hi} (expected <= {exp['max_term']})"
            )
        if "min_commits" in exp:
            n = len(c.metrics.committed_at)
            assert n >= exp["min_commits"], (
                f"only {n} commits (expected >= {exp['min_commits']})"
            )
        for k, v in (exp.get("min_counters") or {}).items():
            got = c.metrics.counters.get(k, 0)
            assert got >= v, f"counter {k}={got} (expected >= {v})"
        for k, v in (exp.get("max_counters") or {}).items():
            got = c.metrics.counters.get(k, 0)
            assert got <= v, f"counter {k}={got} (expected <= {v})"

    def recover(self) -> None:
        """End-of-trace recovery: lift every fault and let the cluster
        settle, so expectations (and the final oracle pass) judge the
        protocol, not a still-partitioned network."""
        c = self.cluster
        c.adversary = None
        c.clear_failure_profiles()  # stop the crash/recover renewal chaos
        c.heal()
        for nid in list(c.nodes):
            if not c.nodes[nid].alive and c.nodes[nid].is_voter():
                c.nodes[nid].restart(c.sim.now)
        settle = float(self.expect.get("settle_ms", 10_000.0))
        lead = c.run_until_leader(max_time=settle)
        # Act like a client: one read forces the lazy __noop__ read barrier,
        # which is how a fresh leader commits prior-term entries in this
        # codebase (there is no eager per-election no-op). Without it a
        # quiet healed cluster keeps acked prior-term entries uncommitted
        # forever and the durability oracle would flag a phantom loss.
        if lead is not None:
            c.read("GET __settle__", via=lead)
        c.run(settle)

    def report(self, ok: bool, error: str = "", step: int = -1, n_ops: int = 0) -> FuzzReport:
        c = self.cluster
        return FuzzReport(
            ok=ok,
            error=error,
            failed_at_step=step,
            n_ops=n_ops,
            n_commits=len(c.metrics.committed_at),
            n_reads_checked=self.n_reads_checked,
            leader_elections=sum(len(s) for s in c.metrics.leaders.values()),
            max_term=max(n.term for n in c.nodes.values()),
            counters=dict(c.metrics.counters),
        )


def replay(trace: Dict[str, Any], engine: str = "slotted") -> FuzzReport:
    """Replay a trace against a fresh cluster; deterministic per trace."""
    ops = trace.get("ops", [])
    with tempfile.TemporaryDirectory(prefix="fuzz-store-") as store_dir:
        runner = _TraceRunner(trace, store_dir, engine=engine)
        for i, op in enumerate(ops):
            try:
                runner.apply_op(op)
                runner.check_oracles()
            except AssertionError as e:
                return runner.report(
                    False, f"step {i} {op.get('op')}: {e}", step=i, n_ops=len(ops)
                )
        try:
            runner.recover()
            runner.check_oracles(final=True)
            runner.check_expectations()
        except AssertionError as e:
            return runner.report(False, f"recovery/expect: {e}", n_ops=len(ops))
        return runner.report(True, n_ops=len(ops))


# ---------------------------------------------------------------- shrinking


def shrink(
    trace: Dict[str, Any], max_replays: int = 200
) -> Tuple[Dict[str, Any], int]:
    """ddmin-style trace minimization: repeatedly try dropping chunks of
    ops (halves, then smaller, down to single ops), keeping any candidate
    that still fails. Returns (shrunk trace, replays used). Deterministic:
    replay order and chunk schedule are fixed by the input alone."""
    ops = list(trace.get("ops", []))
    replays = 0

    def fails(candidate_ops: List[Dict[str, Any]]) -> bool:
        nonlocal replays
        if replays >= max_replays:
            return False
        replays += 1
        t = dict(trace)
        t["ops"] = candidate_ops
        return not replay(t).ok

    chunk = max(1, len(ops) // 2)
    while chunk >= 1:
        i = 0
        progressed = False
        while i < len(ops):
            candidate = ops[:i] + ops[i + chunk:]
            if candidate and fails(candidate):
                ops = candidate
                progressed = True
                # Same position now holds the next chunk; retry in place.
            else:
                i += chunk
        if chunk == 1 and not progressed:
            break
        chunk = chunk // 2 if chunk > 1 else (1 if progressed else 0)
    out = dict(trace)
    out["ops"] = ops
    return out, replays


# --------------------------------------------------------------- generation


class ProtocolFuzzer:
    """Generates one deterministic trace per seed and runs it.

    Generation is decoupled from execution: the whole op schedule is drawn
    up front from ``random.Random(seed)`` with concrete node names, so the
    emitted trace IS the execution — no hidden RNG state to replay."""

    def __init__(
        self,
        seed: int,
        steps: int = 40,
        profile: Optional[FuzzProfile] = None,
        engine: str = "slotted",
    ):
        self.seed = seed
        self.steps = steps
        self.profile = profile or FuzzProfile()
        self.engine = engine

    def generate(self) -> Dict[str, Any]:
        rng = random.Random(self.seed * 0x9E3779B1 + 7)
        p = self.profile
        nodes = [f"n{i}" for i in range(p.n)]
        joiners = 0
        ops: List[Dict[str, Any]] = [{"op": "run", "ms": 2000.0}]
        kinds = (
            # (weight, kind)
            (22, "run"),
            (14, "submit"),
            (10, "read"),
            (8, "partition"),
            (6, "heal"),
            (8, "crash"),
            (8, "restart"),
            (4, "restart_from_store"),
            (5, "adversary"),
            (3, "adversary_off"),
            (4, "clock_skew"),
            (4, "membership"),
        )
        bag = [k for w, k in kinds for _ in range(w)]
        if p.failure_profile:
            # Reliability chaos rides on top of the preset installed at
            # setup: correlated group crashes, plus toggling the profiles
            # off/on mid-trace (testing install/clear at any point).
            bag += ["crash_group"] * 3 + ["failure_profiles"] * 2
        for step in range(self.steps):
            kind = rng.choice(bag)
            if kind == "run":
                ops.append({"op": "run", "ms": rng.choice([200.0, 500.0, 1000.0, 2000.0])})
            elif kind == "submit":
                n = rng.randint(1, 4)
                ops.append(
                    {
                        "op": "submit",
                        "via": rng.choice(nodes),
                        "keys": [f"k{rng.randint(0, 5)}" for _ in range(n)],
                        "vals": [f"s{step}v{j}" for j in range(n)],
                    }
                )
            elif kind == "read":
                op = {
                    "op": "read",
                    "via": rng.choice(nodes),
                    "key": f"k{rng.randint(0, 5)}",
                }
                roll = rng.random()
                if roll < 0.35:
                    op["mode"] = "replica"
                elif roll < 0.55:
                    op["mode"] = "stale"
                    op["staleness_ms"] = rng.choice([100.0, 500.0, 2000.0])
                # else: leader mode (no key — matches pre-replica traces)
                ops.append(op)
            elif kind == "partition":
                cut = rng.randint(1, max(1, len(nodes) - 1))
                picks = rng.sample(nodes, cut)
                rest = [n for n in nodes if n not in picks]
                if picks and rest:
                    ops.append({"op": "partition", "groups": [picks, rest]})
            elif kind == "heal":
                ops.append({"op": "heal"})
            elif kind in ("crash", "restart", "restart_from_store", "clock_skew"):
                node = rng.choice(nodes)
                op: Dict[str, Any] = {"op": kind, "node": node}
                if kind == "restart_from_store":
                    op["seed"] = rng.randint(1, 2**30)
                if kind == "clock_skew":
                    op["offset_ms"] = rng.uniform(-p.clock_skew_ms, p.clock_skew_ms)
                ops.append(op)
            elif kind == "adversary":
                ops.append(
                    {
                        "op": "adversary",
                        "seed": rng.randint(1, 2**30),
                        "drop": round(rng.uniform(0.0, 0.25), 3),
                        "dup": round(rng.uniform(0.0, 0.2), 3),
                        "corrupt": round(rng.uniform(0.0, 0.2), 3),
                        "ms": rng.choice([500.0, 1500.0, 3000.0]),
                    }
                )
            elif kind == "adversary_off":
                ops.append({"op": "adversary_off"})
            elif kind == "crash_group":
                ops.append({"op": "crash_group", "group": f"g{rng.randint(0, 1)}"})
                ops.append({"op": "run", "ms": rng.choice([500.0, 1500.0])})
            elif kind == "failure_profiles":
                ops.append(
                    {
                        "op": "failure_profiles",
                        "preset": rng.choice(["", p.failure_profile]),
                    }
                )
            elif kind == "membership":
                which = rng.random()
                if which < 0.4 and len(nodes) > 3:
                    victim = rng.choice(nodes)
                    nodes = [n for n in nodes if n != victim]
                    ops.append({"op": "membership", "kind": "remove", "node": victim})
                elif which < 0.7:
                    joiners += 1
                    new = f"x{joiners}"
                    old = rng.choice(nodes)
                    nodes = [n for n in nodes if n != old] + [new]
                    ops.append(
                        {"op": "membership", "kind": "replace", "node": old, "new": new}
                    )
                else:
                    joiners += 1
                    new = f"x{joiners}"
                    nodes = nodes + [new]
                    ops.append({"op": "membership", "kind": "add", "node": new})
                ops.append({"op": "run", "ms": 3000.0})
        ops.append({"op": "heal"})
        return make_trace(self.seed, ops, self.profile)

    def run(self) -> Tuple[Dict[str, Any], FuzzReport]:
        trace = self.generate()
        return trace, replay(trace, engine=self.engine)


# ------------------------------------------------------- hierarchy sweep


def hierarchy_sweep(
    seed: int, steps: int = 30, profile: Optional[FuzzProfile] = None,
    engine: str = "slotted",
) -> Tuple[Dict[str, Any], FuzzReport]:
    """Seeded adversary sweep at the HIERARCHY level: three pods under one
    simulation, driven through pod-leader crashes, intra-pod partitions,
    global-link adversaries, pod writes and pod reads in all three modes
    (leader / replica / bounded-stale), with the per-pod read + KV oracles
    checked after every step and the cross-pod delivery oracle at the end.

    Unlike :class:`ProtocolFuzzer` traces this is not ddmin-shrinkable
    (the action log spans several coupled clusters); the log itself is the
    artifact — it is returned (and saved by the CLI) so a failure replays
    by re-running the seed."""
    from repro_torch.core.hierarchy import HierarchicalCluster
    from tests.commit_history import check_kv_consistency, check_read_oracle

    p = profile or FuzzProfile()
    rng = random.Random(seed * 0x9E3779B1 + 13)
    h = HierarchicalCluster(
        n_pods=3, hosts_per_pod=3, seed=seed, config=p.raft_config(),
        state_machine_factory=lambda nid: KVMachine(),
        engine=engine,
    )
    h.bootstrap()
    actions: List[Dict[str, Any]] = []
    writes: Dict[str, List[Tuple[EntryId, str]]] = {pod: [] for pod in h.pod_ids}
    n_reads_checked = 0
    wi = 0
    ok, error, failed_at = True, "", -1

    def live_hosts(pod: str) -> List[str]:
        return [n for n, node in h.pods[pod].nodes.items() if node.alive]

    kinds = [
        "run", "run", "write", "write", "read", "read", "read",
        "crash_leader", "restart_down", "isolate_host", "heal_pod",
        "global_adversary", "global_adversary_off",
    ]
    try:
        for step in range(steps):
            pod = rng.choice(h.pod_ids)
            local = h.pods[pod]
            kind = rng.choice(kinds)
            act: Dict[str, Any] = {"step": step, "op": kind, "pod": pod}
            if kind == "run":
                act["ms"] = rng.choice([200.0, 500.0, 1000.0])
                h.run(act["ms"])
            elif kind == "write":
                hosts = live_hosts(pod)
                if hosts:
                    via = rng.choice(hosts)
                    wi += 1
                    cmd = f"SET hk{rng.randint(0, 4)} w{wi}"
                    act.update(via=via, cmd=cmd)
                    writes[pod].append((local.submit(cmd, via=via), cmd))
            elif kind == "read":
                roll = rng.random()
                if roll < 0.4:
                    mode, staleness, via = "leader", 0.0, None
                elif roll < 0.75:
                    mode, staleness, via = "replica", 0.0, None
                else:
                    mode = "replica"
                    staleness = rng.choice([100.0, 500.0, 2000.0])
                    via = None
                act.update(mode=mode, staleness_ms=staleness)
                h.read_pod(pod, f"GET hk{rng.randint(0, 4)}", via_host=via,
                           mode=mode, max_staleness_ms=staleness)
            elif kind == "crash_leader":
                lead = local.leader()
                if lead is not None:
                    act["node"] = lead
                    local.crash(lead)
            elif kind == "restart_down":
                for nid, node in local.nodes.items():
                    if not node.alive:
                        node.restart(h.sim.now)
                        act.setdefault("nodes", []).append(nid)
            elif kind == "isolate_host":
                hosts = sorted(local.nodes)
                victim = rng.choice(hosts)
                act["node"] = victim
                local.partition([victim], [n for n in hosts if n != victim])
            elif kind == "heal_pod":
                local.heal()
            elif kind == "global_adversary":
                act.update(drop=round(rng.uniform(0.0, 0.3), 3),
                           ms=rng.choice([500.0, 1500.0]))
                h.set_global_adversary(Adversary(
                    seed=rng.randint(1, 2**30), drop_p=act["drop"],
                    until=h.sim.now + act["ms"],
                ))
            elif kind == "global_adversary_off":
                h.set_global_adversary(None)
            actions.append(act)
            for pd in h.pod_ids:
                check_kv_consistency(h.pods[pd])
                check_read_oracle(h.pods[pd], writes[pd])
    except AssertionError as e:
        ok, error, failed_at = False, f"step: {e}", len(actions) - 1
    if ok:
        try:
            # Recovery: lift every fault, settle, and drain the read
            # backlog. One leader-mode read per pod forces the lazy
            # __noop__ barrier, which is also what re-certifies a
            # watermark after leader churn on an idle pod — pending
            # linearizable replica reads drain behind it.
            h.set_global_adversary(None)
            for pod in h.pod_ids:
                local = h.pods[pod]
                local.heal()
                for nid, node in local.nodes.items():
                    if not node.alive:
                        node.restart(h.sim.now)
            h.run(2_000)
            for pod in h.pod_ids:
                h.read_pod(pod, "GET __settle__")
            h.run(8_000)
            for pod in h.pod_ids:
                check_kv_consistency(h.pods[pod])
                n_reads_checked += check_read_oracle(h.pods[pod], writes[pod])
            h.check_consistency()
        except AssertionError as e:
            ok, error = False, f"recovery: {e}"
    n_commits = sum(
        len(h.pods[pod].metrics.committed_at) for pod in h.pod_ids
    )
    report = FuzzReport(
        ok=ok, error=error, failed_at_step=failed_at, n_ops=len(actions),
        n_commits=n_commits, n_reads_checked=n_reads_checked,
    )
    artifact = {
        "version": TRACE_VERSION,
        "seed": seed,
        "kind": "hierarchy_sweep",
        "profile": p.to_dict(),
        "actions": actions,
        "error": error,
    }
    return artifact, report


# ---------------------------------------------------------------------- CLI


def _parse_seeds(spec: str) -> List[int]:
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1-10", help="e.g. 3 or 1,2,9 or 1-20")
    ap.add_argument("--steps", type=int, default=40, help="ops per seed")
    ap.add_argument("--out", default="artifacts/fuzz", help="failing-trace dir")
    ap.add_argument("--no-shrink", action="store_true")
    ap.add_argument("--json", metavar="PATH", help="write run summary JSON")
    ap.add_argument(
        "--coalesce-window", type=float, default=0.0, metavar="MS",
        help="run with RaftConfig.read_coalesce_window=MS (0 = off)",
    )
    ap.add_argument(
        "--election-noop", action="store_true",
        help="run with RaftConfig.election_noop (eager per-term barrier)",
    )
    ap.add_argument(
        "--engine", choices=("slotted", "legacy"), default="slotted",
        help="simulator event engine (schedules are byte-identical; legacy "
        "exists for equivalence gating and performance baselines)",
    )
    ap.add_argument(
        "--hierarchy", action="store_true",
        help="run the hierarchy-level sweep (3 pods, pod-leader crashes, "
        "intra-pod partitions, global-link adversaries, all read modes) "
        "instead of flat-cluster trace fuzzing",
    )
    ap.add_argument(
        "--failure-profile", default="",
        choices=("", "crashy", "slow-cpu", "flaky-links", "mixed"),
        help="install a named FailureProfile preset on every node at setup "
        "and let the fuzzer toggle/crash-group it mid-trace (flat mode only)",
    )
    ap.add_argument(
        "--witnesses", type=int, default=0, metavar="W",
        help="make the last W founding nodes quorum-only witnesses "
        "(flat mode only)",
    )
    ap.add_argument(
        "--link-profile", default="", choices=sorted(LINK_PROFILES),
        help="bandwidth-constrain every link with a named "
        "(bytes_per_ms, mtu_bytes) preset; '' = infinite capacity",
    )
    ap.add_argument(
        "--wire-frugal", action="store_true",
        help="run with RaftConfig.delta_snapshots + ack_piggyback on "
        "(the bandwidth-frugal stack, DESIGN.md section 13)",
    )
    args = ap.parse_args(argv)

    link_bpm, link_mtu = LINK_PROFILES[args.link_profile]
    profile = FuzzProfile(
        read_coalesce_window=args.coalesce_window,
        election_noop=args.election_noop,
        failure_profile=args.failure_profile,
        witnesses=args.witnesses,
        bytes_per_ms=link_bpm,
        mtu_bytes=link_mtu,
        delta_snapshots=args.wire_frugal,
        ack_piggyback=args.wire_frugal,
    )
    rows: List[Dict[str, Any]] = []
    failures = 0
    for seed in _parse_seeds(args.seeds):
        try:
            if args.hierarchy:
                trace, rep = hierarchy_sweep(
                    seed, steps=args.steps, profile=profile, engine=args.engine
                )
            else:
                fz = ProtocolFuzzer(
                    seed, steps=args.steps, profile=profile, engine=args.engine
                )
                trace, rep = fz.run()
        except Exception:  # an oracle escaped as a crash: still a failure
            failures += 1
            print(f"seed {seed}: CRASH\n{traceback.format_exc()}")
            rows.append({"seed": seed, "ok": False, "error": "crash"})
            continue
        row = {"seed": seed, **rep.to_dict()}
        rows.append(row)
        status = "ok" if rep.ok else f"FAIL ({rep.error})"
        print(
            f"seed {seed}: {status} · {rep.n_ops} ops · {rep.n_commits} commits "
            f"· {rep.leader_elections} elections · term<= {rep.max_term} "
            f"· {rep.n_reads_checked} reads checked"
        )
        if not rep.ok:
            failures += 1
            if not args.hierarchy and not args.no_shrink:
                trace, used = shrink(trace)
                print(
                    f"  shrunk to {len(trace['ops'])} ops in {used} replays; "
                    f"verdict: {replay(trace).error}"
                )
            name = ("hier-" if args.hierarchy else "") + f"seed{seed}.json"
            path = os.path.join(args.out, name)
            save_trace(trace, path)
            print(f"  trace saved: {path}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    print(f"{len(rows)} seeds, {failures} failing")
    return 1 if failures else 0


if __name__ == "__main__":
    # The oracle suite lives under tests/ at the repo root (src/../..):
    # make `from tests.commit_history import ...` work for CLI runs that
    # only have src/ on PYTHONPATH.
    _repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    )
    sys.path.insert(0, _repo_root)
    raise SystemExit(main())
