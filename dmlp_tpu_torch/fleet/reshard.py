"""Staged capacity re-split: grow a replica's resident layout on ingest.

Port of ``dmlp_tpu/fleet/reshard.py``. A resident engine stages its
corpus once into a layout fixed for the process's life (the mesh-resident
engine's per-rank shard buffers especially), so ingest that approaches
the capacity needs a new layout. The choreography drops and corrupts no
response:

1. **Spawn the replacement** from the supervisor's spec with a grown
   capacity (the next power of two at ``grow_factor`` times the old); for
   a mesh replica this re-plans the shard rows and chunks. It is not yet
   in the routing table and holds the base corpus file only.
2. **Replay the delta, checksum-verified.** The ingested rows the base
   file lacks are paged out of the old replica (the ``corpus`` wire op)
   and written into the replacement as idempotent ``start``-keyed
   row-writes: :func:`fleet.consistency.repair_replica` is the replay
   loop, re-checking the corpus signature between rounds.
3. **Swap.** The verified replacement enters the routing table; the old
   replica is marked draining (its corpus freezes), a final catch-up
   copies what landed in between, and only then is the old replica
   removed and drained (exit 0). The router's consistency prober covers
   the last sliver like any divergence.

A failure at any stage backs out: the replacement is killed, the old
replica keeps serving, and ``fleet.reshard.failures`` records it. Success
records ``fleet.reshard.splits`` / ``replayed_rows`` / ``catchup_rounds``.
"""

from __future__ import annotations

from typing import Any, Dict

from dmlp_tpu_torch.fleet import consistency as ccs
from dmlp_tpu_torch.fleet.router import Replica
from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs.trace import instant as obs_instant
from dmlp_tpu_torch.tune.cache import shape_bucket


def grown_capacity(capacity_rows: int, rows: int,
                   grow_factor: int = 2) -> int:
    """The replacement layout's row capacity: the next power-of-two
    covering ``grow_factor`` × the old capacity (and always the
    current row count + headroom)."""
    return shape_bucket(max(int(capacity_rows) * max(grow_factor, 2),
                            int(rows) + 1))


def needs_resplit(rows: int, capacity_rows: int,
                  threshold: float = 0.9) -> bool:
    """Has ingest approached the capacity-padded buffer limit?"""
    return capacity_rows > 0 and rows >= threshold * capacity_rows


def execute_resplit(supervisor, mr, grow_factor: int = 2,
                    max_catchup: int = 8) -> Dict[str, Any]:
    """Split ``mr`` (a :class:`fleet.autoscale.ManagedReplica`): spawn
    the grown replacement, replay + verify, swap, drain the old one.
    Returns a result dict (``ok``, and on success ``capacity``,
    ``replayed_rows``, ``rounds``, ``old_rc``)."""
    reg = telemetry.registry()
    router = supervisor.router
    old_rep = mr.replica
    sig = old_rep.last_corpus or ccs.corpus_state_via_wire(old_rep)
    if sig is None:
        reg.counter("fleet.reshard.failures").inc(label="source_gone")
        return {"ok": False, "reason": "source replica unreachable"}
    old_cap = old_rep.capacity_rows or int(sig["rows"])
    new_cap = grown_capacity(old_cap, sig["rows"],
                             grow_factor=grow_factor)
    name = f"{mr.name}_g{mr.generation + 1}"
    obs_instant("fleet.reshard.begin", replica=mr.name,
                rows=sig["rows"], old_capacity=old_cap,
                new_capacity=new_cap)
    try:
        fp = supervisor.spawn_proc(name, capacity=new_cap)
    except Exception as e:  # check: no-retry — a failed spawn leaves the old replica
        # serving at its old capacity (recorded; the next threshold
        # crossing retries with a fresh process)
        reg.counter("fleet.reshard.failures").inc(label="spawn")
        return {"ok": False, "reason": f"spawn failed: {e}"}
    new_rep = Replica("127.0.0.1", fp.ready["port"],
                      scrape_port=fp.scrape_port)
    replayed = 0
    rounds = 0
    try:
        # 2. replay the delta into the (not yet routed) replacement,
        # looping until rows AND rolling checksum match the source.
        res = ccs.repair_replica(old_rep, new_rep,
                                 max_rounds=max_catchup)
        replayed += res["replayed_rows"]
        rounds += res["rounds"]
        if not res["repaired"]:
            # Back out: the unregistered replacement must DIE here —
            # it is in neither the routing table nor the supervisor's
            # managed set, so nothing else would ever reap it (and the
            # next threshold crossing would spawn another).
            fp.proc.kill()
            try:
                fp.proc.wait(timeout=30)
            except Exception:  # check: no-retry — the OS owns it now
                pass
            reg.counter("fleet.reshard.failures").inc(label="replay")
            return {"ok": False,
                    "reason": f"replay did not verify: "
                              f"{res.get('reason')}"}
        # 3. the swap: replacement IN, old replica frozen (draining
        # stops both query routing and ingest fan-out to it), final
        # catch-up over the frozen corpus, then out through the drain
        # choreography.
        new_mr = supervisor.register(fp, capacity=new_cap,
                                     generation=mr.generation + 1)
        old_rep.mark(draining=True)
        final = ccs.repair_replica(old_rep, new_rep,
                                   max_rounds=max_catchup)
        replayed += final["replayed_rows"]
        rounds += final["rounds"]
        if not final["repaired"]:
            # Back out: the replacement leaves the table, the old
            # replica resumes (its corpus is intact — nothing was
            # written to it).
            supervisor.retire(new_mr, drain=True,
                              reason="reshard_backout")
            old_rep.mark(draining=False)
            reg.counter("fleet.reshard.failures").inc(label="verify")
            return {"ok": False,
                    "reason": f"final verify failed: "
                              f"{final.get('reason')}"}
    except Exception:
        fp.proc.kill()
        raise
    old_rc = supervisor.retire(mr, drain=True, reason="reshard")
    reg.counter("fleet.reshard.splits").inc()
    reg.counter("fleet.reshard.replayed_rows").inc(replayed)
    reg.counter("fleet.reshard.catchup_rounds").inc(max(rounds, 1))
    telemetry.registry().gauge("fleet.reshard.capacity_rows").set(
        new_cap)
    obs_instant("fleet.reshard.swap", old=mr.name, new=name,
                capacity=new_cap, replayed_rows=replayed,
                old_rc=old_rc)
    telemetry.flight_event("fleet.reshard.split", old=mr.name,
                           new=name, capacity=new_cap)
    return {"ok": True, "replica": name, "capacity": new_cap,
            "replayed_rows": replayed, "rounds": rounds,
            "old_rc": old_rc}
