"""Checkable models of the cluster protocols (port of
``pathway_tpu/internals/protocol_models.py``).

The models are the reference's models of its own protocols, ported as they
are: under the same seed or ``choices=`` each takes the same decisions as
the reference's. The module names below are the reference's.

The reference's docstring follows.

Each model is a small, faithful port of one hand-written thread protocol from
the runtime — the epoch fence/rejoin install (``parallel/cluster.py``), the
snapshot→ack→manifest→compact coordinated checkpoint (``engine/runner.py`` +
``persistence/engine.py``), and the query-coalescer admission/shed path
(``models/embed_pipeline.py``) — rewritten against ``internals/sched.py``
primitives so EVERY interleaving decision is scheduler-controlled. Run them
under :func:`~pathway_tpu_torch.internals.sched.explore` (bounded-exhaustive DFS) or
:func:`~pathway_tpu_torch.internals.sched.sweep_seeds` (seeded walks) and the
invariants below hold on every schedule — or fail with a replayable choice
sequence:

- **fence/rejoin**: no stale-epoch frame is ever delivered, future-epoch
  frames park and deliver exactly once at install, every survivor adopts the
  new epoch, and the protocol never deadlocks;
- **checkpoint**: at most one manifest per commit id, compaction only behind
  a durable manifest, and an aborted attempt leaves the previous manifest
  intact;
- **coalescer**: every request is shed XOR answered, admission slots are
  always released (queued rows return to zero), and close never strands a
  waiter;
- **encoder service**: the continuous-batching admission/tick/shutdown
  protocol (``models/encoder_service.py``) — every request shed XOR answered,
  waiting and in-flight row counts return to zero, shutdown drains the queue,
  and the timed tick keeps the idle wait abortable (no lost-wakeup deadlock).

Each model takes a ``bug=`` knob that plants a realistic regression
(``"no_purge"`` skips the install-time inbox purge, ``"toctou_commit"``
releases the manifest lock between the read-back check and the write,
``"leak_slot"`` drops the queued-row release on the encode error path,
``"no_timeout"`` makes a wait unabortable). The broken variants exist so the
model-check suite can prove it DETECTS the bug class with a replayable
schedule — the safety net the membership protocol runs
under.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from pathway_tpu_torch.internals.sched import DeterministicScheduler

# ---------------------------------------------------------------------------
# fence broadcast + rejoin install (parallel/cluster.py)
# ---------------------------------------------------------------------------


class _ModelSurvivor:
    """One fenced survivor: epoch-checked inbox with park/drop semantics —
    the reader-thread logic of ``ClusterExchange._reader`` + the install step
    of ``await_rejoin``, minus the sockets."""

    def __init__(self, sched: DeterministicScheduler, idx: int, bug: Optional[str]):
        self.idx = idx
        self.bug = bug
        self.cv = sched.condition(name=f"s{idx}.cv")
        self.epoch = 0
        self.inbox: List[tuple] = []  # (frame_epoch, payload) awaiting delivery
        self.parked: List[tuple] = []  # future-epoch frames
        self.delivered: List[tuple] = []  # (frame_epoch, epoch_at_delivery, payload)
        self.stale_dropped = 0
        self.fence_pending = False
        self.rejoin_ready = False
        self.installed = False

    def on_frame(self, frame_epoch: int, payload: str) -> None:
        """A peer/replacement/zombie frame arrives (any thread)."""
        with self.cv:
            if frame_epoch < self.epoch and self.bug != "deliver_stale":
                self.stale_dropped += 1
                return
            if frame_epoch > self.epoch:
                self.parked.append((frame_epoch, payload))
                self.cv.notify_all()
                return
            self.inbox.append((frame_epoch, payload))
            self.cv.notify_all()

    def set_fence(self) -> None:
        with self.cv:
            self.fence_pending = True
            self.cv.notify_all()

    def set_rejoin_ready(self) -> None:
        with self.cv:
            self.rejoin_ready = True
            self.cv.notify_all()

    def install(self, new_epoch: int) -> None:
        """Adopt the rejoin: purge the aborted epoch's inbox, deliver parked
        frames already sent at the adopted epoch."""
        with self.cv:
            if self.bug != "no_purge":
                self.stale_dropped += len(self.inbox)
                self.inbox = []
            self.epoch = new_epoch
            keep = [(e, p) for (e, p) in self.parked if e == new_epoch]
            self.stale_dropped += len(self.parked) - len(keep)
            self.inbox.extend(keep)
            self.parked = []
            self.installed = True
            self.cv.notify_all()

    def drain(self, expect: int) -> None:
        """Deliver frames until ``expect`` post-install frames arrived."""
        while True:
            with self.cv:
                while self.inbox:
                    frame_epoch, payload = self.inbox.pop(0)
                    self.delivered.append((frame_epoch, self.epoch, payload))
                if len([d for d in self.delivered if d[1] == self.epoch]) >= expect:
                    return
                self.cv.wait()


def fence_rejoin_model(
    n_survivors: int = 2, *, bug: Optional[str] = None
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The surgical-restart epoch fence: ``n_survivors`` fenced survivors, a
    fence broadcaster, a zombie still sending epoch-0 frames (the dead rank's
    in-flight traffic), and a replacement dialing in and then talking at
    epoch 1. Survivors that install first immediately send epoch-1 frames to
    the others — the future-epoch parking path races exactly like the real
    mesh. Invariants: every delivered frame matches the epoch at delivery, no
    parked frames are stranded, all survivors converge to epoch 1, and the
    protocol cannot deadlock."""

    new_epoch = 1

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        survivors = [_ModelSurvivor(sched, i, bug) for i in range(n_survivors)]
        # post-install each survivor expects: one replacement frame + one
        # frame from every other survivor
        expect = 1 + (n_survivors - 1)

        def survivor_body(me: _ModelSurvivor) -> None:
            # barrier-wait aborted by the fence (ClusterFenceError path)
            with me.cv:
                while not me.fence_pending:
                    me.cv.wait()
            # await_rejoin: quiesce until the replacement re-dialed
            with me.cv:
                while not me.rejoin_ready:
                    me.cv.wait()
            me.install(new_epoch)
            # replayed barriers: talk to the other survivors at the new epoch
            for peer in survivors:
                if peer is not me:
                    peer.on_frame(new_epoch, f"s{me.idx}->s{peer.idx}")
            me.drain(expect)

        def zombie_body() -> None:
            # the dead rank's frames still in flight: stale once epochs move
            for peer in survivors:
                peer.on_frame(0, f"zombie->s{peer.idx}")

        def fence_body() -> None:
            for peer in survivors:
                peer.set_fence()

        def replacement_body() -> None:
            # re-dial each survivor (install order is scheduler-chosen) …
            for peer in survivors:
                peer.set_rejoin_ready()
            # … then run the replayed barriers at the new epoch
            for peer in survivors:
                peer.on_frame(new_epoch, f"replacement->s{peer.idx}")

        for surv in survivors:
            sched.spawn(survivor_body, surv, name=f"survivor{surv.idx}")
        sched.spawn(fence_body, name="fence")
        sched.spawn(zombie_body, name="zombie")
        sched.spawn(replacement_body, name="replacement")

        def check() -> None:
            for surv in survivors:
                assert surv.epoch == new_epoch, (
                    f"survivor {surv.idx} never adopted epoch {new_epoch}"
                )
                assert not surv.parked, (
                    f"survivor {surv.idx} stranded parked frames: {surv.parked}"
                )
                for frame_epoch, at_epoch, payload in surv.delivered:
                    assert frame_epoch == at_epoch, (
                        f"stale-epoch delivery on survivor {surv.idx}: frame "
                        f"{payload!r} from epoch {frame_epoch} delivered at "
                        f"epoch {at_epoch}"
                    )
                post = [d for d in surv.delivered if d[1] == new_epoch]
                assert len(post) == expect, (
                    f"survivor {surv.idx} delivered {len(post)} post-install "
                    f"frames, expected {expect}"
                )
                # install + frame conservation (last, so the planted-bug
                # batteries keep their original first-failure messages):
                # adopting the epoch must have gone THROUGH install(), and
                # every frame addressed to a survivor (zombie + replacement +
                # each peer) is accounted for — delivered or dropped stale,
                # never silently vanished
                assert surv.installed, (
                    f"survivor {surv.idx} adopted epoch {new_epoch} without "
                    "running install()"
                )
                assert len(surv.delivered) + surv.stale_dropped == n_survivors + 1, (
                    f"survivor {surv.idx} frame accounting broke: "
                    f"{len(surv.delivered)} delivered + {surv.stale_dropped} "
                    f"stale-dropped != {n_survivors + 1} sent"
                )

        return check

    return model


# ---------------------------------------------------------------------------
# coordinated checkpoint: snapshot → ack → manifest → compact
# ---------------------------------------------------------------------------


def checkpoint_model(
    n_ranks: int = 3,
    *,
    crash_rank: Optional[int] = None,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The aligned checkpoint protocol at one commit id: every rank snapshots,
    acks durability, rank 0 commits the read-back-verified manifest only after
    ALL acks, everyone compacts only behind the manifest. A ``backup``
    committer models the retry path — with the real protocol's
    check-and-commit held under one lock it can never double-commit; with
    ``bug="toctou_commit"`` the lock drops between the read-back check and the
    write, and some interleaving commits the manifest twice.
    ``crash_rank`` kills one rank after its snapshot (the chaos
    ``post_snapshot_kill``): the ack barrier must then abort on its deadline
    and leave the PREVIOUS manifest intact."""

    commit_id = 7

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("store")
        cv = sched.condition(lock, name="store.cv")
        store: Dict[str, Any] = {
            "snapshots": {},  # rank -> commit id
            "acks": set(),
            "manifests": [("prev", commit_id - 1)],  # the durable previous checkpoint
            "compacted": set(),
            "aborted": False,
        }
        # a barrier wait is abortable by construction in the real protocol
        # (the mesh barrier deadline); model the deadline as a bounded number
        # of timeout wakeups
        deadline_polls = 4

        def ack_barrier_wait() -> bool:
            """True when every rank acked; False = deadline expired (abort)."""
            polls = 0
            with cv:
                while len(store["acks"]) < n_ranks:
                    if store["aborted"]:
                        return False
                    timeout = None if bug == "no_timeout" else 1.0
                    if not cv.wait(timeout=timeout):
                        polls += 1
                        if polls >= deadline_polls:
                            store["aborted"] = True
                            cv.notify_all()
                            return False
                return not store["aborted"]

        def commit_manifest() -> None:
            """Read-back-verified manifest commit (rank 0 and the retry path
            race through here; the lock must cover check AND write)."""
            if bug == "toctou_commit":
                with lock:
                    already = any(m[0] == "ckpt" for m in store["manifests"])
                sched.yield_point("manifest-gap")  # lock dropped: the TOCTOU window
                if not already:
                    with lock:
                        store["manifests"].append(("ckpt", commit_id))
            else:
                with lock:
                    if not any(m[0] == "ckpt" for m in store["manifests"]):
                        store["manifests"].append(("ckpt", commit_id))
            with cv:
                cv.notify_all()

        def rank_body(rank: int) -> None:
            with cv:
                store["snapshots"][rank] = commit_id
            sched.yield_point("snapshot-durable")
            if rank == crash_rank:
                return  # post-snapshot kill: no ack ever arrives
            with cv:
                store["acks"].add(rank)
                cv.notify_all()
            ok = ack_barrier_wait()
            if rank == 0 and ok:
                commit_manifest()
            # outcome: compact only once a manifest for THIS commit is durable
            polls = 0
            with cv:
                while not any(m == ("ckpt", commit_id) for m in store["manifests"]):
                    if store["aborted"]:
                        return
                    if not cv.wait(timeout=1.0):
                        polls += 1
                        if polls >= deadline_polls:
                            return
                store["compacted"].add(rank)

        def backup_committer() -> None:
            """The retry path: re-drive the manifest commit once every ack is
            in (a supervisor re-poke after a slow rank 0). Safe only because
            commit_manifest re-verifies under the lock."""
            polls = 0
            with cv:
                while len(store["acks"]) < n_ranks:
                    if store["aborted"]:
                        return
                    if not cv.wait(timeout=1.0):
                        polls += 1
                        if polls >= deadline_polls:
                            return
            commit_manifest()

        for rank in range(n_ranks):
            sched.spawn(rank_body, rank, name=f"rank{rank}")
        sched.spawn(backup_committer, name="backup")

        def check() -> None:
            manifests = [m for m in store["manifests"] if m == ("ckpt", commit_id)]
            assert len(manifests) <= 1, (
                f"double manifest commit for commit {commit_id}: "
                f"{store['manifests']}"
            )
            assert ("prev", commit_id - 1) in store["manifests"], (
                "previous checkpoint manifest was lost"
            )
            if crash_rank is not None:
                assert not manifests, (
                    "manifest committed although a rank died before acking"
                )
            for rank in store["compacted"]:
                assert manifests, (
                    f"rank {rank} compacted its journal with no durable manifest"
                )

        return check

    return model


# ---------------------------------------------------------------------------
# query-coalescer admission / shed (models/embed_pipeline.py)
# ---------------------------------------------------------------------------


def coalescer_model(
    n_clients: int = 3,
    *,
    cap: int = 2,
    fail_batch: bool = False,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The QueryCoalescer admission protocol: clients admit one row each
    against ``cap`` queued rows (past it they shed), a worker batches the
    queue and answers every taken request, close() wakes everyone. With
    ``fail_batch`` the encoder raises on the first batch — the error must
    propagate to exactly the taken requests WITH their admission slots
    released (``bug="leak_slot"`` drops the release on that path, the real
    regression class behind a permanently-429 coalescer)."""

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("coalescer")
        cv = sched.condition(lock, name="coalescer.cv")
        state: Dict[str, Any] = {
            "queue": [],  # request ids waiting for the worker
            "queued_rows": 0,
            "shed": set(),
            "answered": set(),
            "errored": set(),
            "closed": False,
            "batches": 0,
        }

        def client_body(req: int) -> None:
            with cv:
                if state["queued_rows"] + 1 > cap:
                    state["shed"].add(req)
                    cv.notify_all()  # a shed is a terminal outcome too
                    return
                state["queue"].append(req)
                state["queued_rows"] += 1
                cv.notify_all()

        def worker_body() -> None:
            while True:
                with cv:
                    # notify-driven idle wait (every queue/closed transition
                    # notifies): an untimed wait here also makes the deadlock
                    # detector prove no state change can be missed
                    while not state["queue"]:
                        if state["closed"]:
                            return
                        cv.wait()
                    take = list(state["queue"])
                    state["queue"] = []
                fail = fail_batch and state["batches"] == 0
                state["batches"] += 1
                sched.yield_point("encode")
                with cv:
                    if fail:
                        state["errored"].update(take)
                        if bug != "leak_slot":
                            state["queued_rows"] -= len(take)
                    else:
                        state["answered"].update(take)
                        state["queued_rows"] -= len(take)
                    cv.notify_all()

        def closer_body() -> None:
            # close after every client's request reached a terminal state
            with cv:
                while (
                    len(state["shed"]) + len(state["answered"]) + len(state["errored"])
                    < n_clients
                ):
                    cv.wait()
                state["closed"] = True
                cv.notify_all()

        sched.spawn(worker_body, name="worker")
        for req in range(n_clients):
            sched.spawn(client_body, req, name=f"client{req}")
        sched.spawn(closer_body, name="closer")

        def check() -> None:
            outcomes = [state["shed"], state["answered"], state["errored"]]
            seen: set = set()
            for group in outcomes:
                assert not (seen & group), f"request answered twice: {seen & group}"
                seen |= group
            assert seen == set(range(n_clients)), (
                f"requests stranded with no outcome: {set(range(n_clients)) - seen}"
            )
            assert state["queued_rows"] == 0, (
                f"admission slots leaked: {state['queued_rows']} rows still "
                "counted after every request terminated"
            )

        return check

    return model


# ---------------------------------------------------------------------------
# encoder-service admission / tick / shutdown (models/encoder_service.py)
# ---------------------------------------------------------------------------


def encoder_service_model(
    n_clients: int = 3,
    *,
    cap: int = 2,
    max_inflight: int = 2,
    fail_batch: bool = False,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The EncoderService protocol, modeled BEFORE the real threads were wired
    (model first, then wire): clients admit one row each against ``cap`` waiting
    rows (past it they shed); a continuous-batching worker takes up to
    ``max_inflight`` rows per tick, encodes, answers exactly the taken
    requests, and releases the in-flight slots; a stopper requests shutdown
    once every client made its admission decision, and the worker must DRAIN
    the queue before exiting. Clients abort typed only when the worker is gone
    with their request still queued (the self-heal/abort path of
    ``EncoderService._await``).

    All waits are modeled UNTIMED (notify-driven, like the coalescer model):
    under the deadlock detector that PROVES every state transition notifies
    its waiters — the real implementation's timed tick/poll bounds are
    defense-in-depth on top of a protocol shown to need no timeout wakeups.

    Invariants: no deadlock, every request shed XOR answered XOR errored
    (none aborted/dropped under the correct protocol), and slots always
    released (waiting AND in-flight row counts return to zero).

    Planted bugs: ``"leak_inflight"`` drops the in-flight release on the
    encode-error path (the slot-leak class behind a permanently-"full"
    service); ``"drop_on_close"`` makes the worker exit on stop WITHOUT
    draining, stranding admitted requests (caught as aborted requests);
    ``"lost_close_wakeup"`` drops the stop notify — the lost-wakeup deadlock
    class, caught because the idle wait is notify-driven."""

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("svc")
        cv = sched.condition(lock, name="svc.cv")
        state: Dict[str, Any] = {
            "queue": [],  # admitted request ids waiting for the worker
            "queued_rows": 0,
            "inflight_rows": 0,
            "decided": 0,  # clients whose admission decision happened
            "shed": set(),
            "answered": set(),
            "errored": set(),
            "aborted": set(),
            "stop": False,
            "worker_done": False,
            "ticks": 0,
        }

        def client_body(req: int) -> None:
            with cv:
                if state["queued_rows"] + 1 > cap:
                    state["shed"].add(req)
                    state["decided"] += 1
                    cv.notify_all()
                    return
                state["queue"].append(req)
                state["queued_rows"] += 1
                state["decided"] += 1
                cv.notify_all()
            # notify-driven wait for a terminal outcome; typed abort only when
            # no worker remains to drain the queue
            with cv:
                while req not in state["answered"] and req not in state["errored"]:
                    if state["worker_done"] and req in state["queue"]:
                        state["queue"].remove(req)
                        state["queued_rows"] -= 1
                        state["aborted"].add(req)
                        cv.notify_all()
                        return
                    cv.wait()

        def worker_body() -> None:
            while True:
                with cv:
                    while not state["queue"]:
                        if state["stop"]:
                            state["worker_done"] = True
                            cv.notify_all()
                            return
                        cv.wait()  # notify-driven idle wait (see docstring)
                    if bug == "drop_on_close" and state["stop"]:
                        # exits with the queue non-empty: admitted requests drop
                        state["worker_done"] = True
                        cv.notify_all()
                        return
                    take = []
                    while state["queue"] and len(take) < max_inflight:
                        take.append(state["queue"].pop(0))
                    state["queued_rows"] -= len(take)
                    state["inflight_rows"] += len(take)
                fail = fail_batch and state["ticks"] == 0
                state["ticks"] += 1
                sched.yield_point("encode")
                with cv:
                    if fail:
                        state["errored"].update(take)
                        if bug != "leak_inflight":
                            state["inflight_rows"] -= len(take)
                    else:
                        state["answered"].update(take)
                        state["inflight_rows"] -= len(take)
                    cv.notify_all()

        def stopper_body() -> None:
            # server stop races the in-flight tick: shutdown may begin as soon
            # as every client made its admission decision — admitted-but-
            # unanswered requests must still be drained
            with cv:
                while state["decided"] < n_clients:
                    cv.wait()
                state["stop"] = True
                if bug != "lost_close_wakeup":
                    cv.notify_all()

        sched.spawn(worker_body, name="worker")
        for req in range(n_clients):
            sched.spawn(client_body, req, name=f"client{req}")
        sched.spawn(stopper_body, name="stopper")

        def check() -> None:
            groups = [
                state["shed"], state["answered"], state["errored"], state["aborted"],
            ]
            seen: set = set()
            for group in groups:
                assert not (seen & group), f"request in two outcomes: {seen & group}"
                seen |= group
            assert seen == set(range(n_clients)), (
                f"requests stranded with no outcome: {set(range(n_clients)) - seen}"
            )
            assert not state["aborted"], (
                f"admitted requests dropped at shutdown (worker exited without "
                f"draining): {state['aborted']}"
            )
            assert state["queued_rows"] == 0, (
                f"admission slots leaked: {state['queued_rows']} rows still "
                "queued after every request terminated"
            )
            assert state["inflight_rows"] == 0, (
                f"in-flight slots leaked: {state['inflight_rows']} rows still "
                "counted after every request terminated"
            )
            if not fail_batch:
                assert not state["errored"]

        return check

    return model


# ---------------------------------------------------------------------------
# elastic membership change: quiesce -> handoff -> manifest -> install
# ---------------------------------------------------------------------------


class _ModelMember:
    """One cluster member in the membership-change model: an epoch-checked
    mailbox (stale frames dropped, future frames parked — the
    ``ClusterExchange._reader`` discipline) plus a slot-ownership map that
    must only change at install time."""

    def __init__(self, sched: DeterministicScheduler, rank: int, owned: "set[int]"):
        self.rank = rank
        self.cv = sched.condition(name=f"m{rank}.cv")
        self.epoch = 0
        self.owned = set(owned)  # slots this member serves rows for
        self.tokens: Dict[int, "set[str]"] = {}  # slot -> row tokens held here
        self.emitted: Dict[int, bool] = {}  # slot -> join match already emitted
        self.inbox: List[tuple] = []  # (frame_epoch, slot, token)
        self.parked: List[tuple] = []  # future-epoch frames
        self.delivered: List[tuple] = []  # (frame_epoch, epoch_at_delivery, slot)
        self.bad_rows: List[tuple] = []  # rows delivered for a slot not owned
        self.stale_dropped = 0
        self.released = False  # leaver gave up its process

    def on_frame(self, frame_epoch: int, slot: int, token: str) -> None:
        with self.cv:
            if frame_epoch < self.epoch:
                self.stale_dropped += 1
                return
            if frame_epoch > self.epoch:
                self.parked.append((frame_epoch, slot, token))
                self.cv.notify_all()
                return
            self.inbox.append((frame_epoch, slot, token))
            self.cv.notify_all()


def membership_model(
    old_n: int = 2,
    new_n: int = 3,
    *,
    n_slots: int = 6,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The epoch-fenced elastic membership transition (``MEMBERSHIP_CHANGE``):
    ``old_n`` live members quiesce at a commit boundary, partition their
    per-slot state into handoff fragments addressed by the NEW ownership map
    (slot -> rank = slot % new_n), ack durability, rank 0 commits the single
    membership manifest (check-and-write under one lock), and only then does
    every member of the new topology install — adopting the new epoch, the
    new ownership map, and the imported fragments atomically — while leavers
    release only after their fragments are durable and the manifest
    committed. Joiners import their fragments and join post-install traffic;
    every member then routes one row per moved slot to its owner under the
    new map (epoch-stamped frames park at not-yet-installed receivers, the
    real mesh's future-epoch discipline).

    Universal-reshard extension: each slot additionally holds JOIN-side
    state — a build-side token (``jleft``), a probe-side token (``jright``)
    and per-slot match bookkeeping. Donors emit each slot's match exactly
    once pre-cut; the bookkeeping rides the fragments so the new owner does
    NOT re-emit after install. Fragments themselves travel as a CHUNKED
    stream per (donor, dest) pair — two bounded chunks followed by a chunk
    manifest naming the chunk count — and an installer imports a stream
    only when its manifest matches (complete-or-abort).

    Invariants over every interleaving: every slot owned by exactly one live
    member at the final epoch (and by the mapped owner); the row-token set
    INCLUDING both join sides is preserved across the handoff (no row lost
    or duplicated) and resides with the slot's owner; every slot's match is
    emitted exactly once (never replayed across the cut); chunk streams are
    complete-or-abort (a manifest never overstates its chunks); no
    stale-epoch delivery and no row delivered to a non-owner; leavers fully
    drained (fragments durable) before release; no deadlock.

    Planted bugs (each must be CAUGHT with a replayable schedule):
    ``"double_owner"`` — a donor keeps serving slots it handed off (two
    owners at the new epoch, rows duplicated); ``"orphan_range"`` — one moved
    slot's fragment is dropped (a key range with no surviving rows);
    ``"release_before_drain"`` — a leaver releases before writing its
    fragments (its rows are lost); ``"epoch_before_install"`` — the epoch is
    bumped and traffic resumes before the ownership map installs, so rows
    route to ranks that no longer own the slot; ``"join_row_orphan"`` — one
    moved slot's probe-side join rows are left out of its fragment (the
    arrangement re-keys under the new map but the probe side is gone);
    ``"double_match"`` — match bookkeeping is dropped from the fragments, so
    the new owner re-emits matches the donor already emitted;
    ``"torn_chunk_install"`` — a donor tears one chunk stream (chunk written,
    no manifest) yet still acks, and the installer imports the partial
    stream instead of aborting it; ``"owner_map_stale"`` — a donor partitions
    its fragments with a stale ownership map, landing rows on ranks that do
    not own them under the committed map."""

    grow = new_n >= old_n
    members_after = list(range(new_n))
    joiners = list(range(old_n, new_n)) if grow else []
    leavers = list(range(new_n, old_n)) if not grow else []
    new_epoch = 1

    def old_owner(slot: int) -> int:
        return slot % old_n

    def new_owner(slot: int) -> int:
        return slot % new_n

    moved = {s for s in range(n_slots) if new_owner(s) != old_owner(s)}

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("store")
        cv = sched.condition(lock, name="store.cv")
        store: Dict[str, Any] = {
            "ready": set(),
            # (donor, dest) -> [chunk, ...]; each chunk is
            # {"slots": {slot: tokens}, "emitted": {slot: bool}} and is
            # durable once appended (the bounded-transport stream)
            "chunks": {},
            "chunk_manifest": {},  # (donor, dest) -> promised chunk count
            "acks": set(),
            "manifests": [],
            "matches": [],  # every join match ever emitted, in order
            "misrouted": [],  # rows routed to a released leaver (lost)
            "traffic_done": 0,  # new-topology members done sending
        }
        init_owned = {
            m: {s for s in range(n_slots) if old_owner(s) == m}
            for m in range(old_n)
        }
        members: Dict[int, _ModelMember] = {
            m: _ModelMember(sched, m, init_owned[m]) for m in range(old_n)
        }
        for j in joiners:
            members[j] = _ModelMember(sched, j, set())
        for m in range(old_n):
            for s in init_owned[m]:
                # two plain rows + the join arrangement's build and probe
                # sides — all four must survive the cut together
                members[m].tokens[s] = {
                    f"row{s}a", f"row{s}b", f"jleft{s}", f"jright{s}"
                }

        def notify_everyone() -> None:
            for mm in members.values():
                with mm.cv:
                    mm.cv.notify_all()

        def emit_matches(m: int) -> None:
            """Join matches: emit each owned slot's match exactly once (the
            bookkeeping is per-slot state and rides the handoff fragments)."""
            me = members[m]
            with me.cv:
                slots = sorted(me.owned)
            for slot in slots:
                with me.cv:
                    have = me.tokens.get(slot, set())
                    both = any(t.startswith("jleft") for t in have) and any(
                        t.startswith("jright") for t in have
                    )
                    if not both or me.emitted.get(slot):
                        continue
                    me.emitted[slot] = True
                with cv:
                    store["matches"].append(f"match{slot}")
                    cv.notify_all()

        def write_fragments(m: int) -> None:
            """Chunked handoff: per destination the donor streams TWO bounded
            chunks, then commits a chunk manifest naming the count — the
            installer's complete-or-abort basis."""
            me = members[m]
            skipped = False
            streams: Dict[int, list] = {}
            with me.cv:
                owned_slots = sorted(me.owned)
            for slot in owned_slots:
                dest = new_owner(slot)
                if bug == "owner_map_stale" and m == 0 and slot in moved:
                    # a stale (prior-attempt) ownership map partitions the
                    # fragment: rows land on ranks the committed map does
                    # not assign the slot to
                    dest = (new_owner(slot) + 1) % new_n
                if dest == m:
                    continue  # kept slots stay in place
                if bug == "orphan_range" and m == 0 and slot in moved and not skipped:
                    skipped = True  # this key range's fragment never lands
                    continue
                toks = sorted(me.tokens.get(slot, set()))
                if (
                    bug == "join_row_orphan" and m == 0 and slot in moved
                    and not skipped
                ):
                    # the probe-side join rows are left out of the fragment
                    skipped = True
                    toks = [t for t in toks if not t.startswith("jright")]
                half = (len(toks) + 1) // 2
                st = streams.setdefault(dest, [
                    {"slots": {}, "emitted": {}},
                    {"slots": {}, "emitted": {}},
                ])
                st[0]["slots"][slot] = set(toks[:half])
                st[1]["slots"][slot] = set(toks[half:])
                if bug != "double_match":
                    # match bookkeeping rides the SECOND chunk (torn streams
                    # must not leave it half-installed either)
                    st[1]["emitted"][slot] = bool(me.emitted.get(slot))
            torn_dest = min(streams) if streams else None
            for dest in sorted(streams):
                c0, c1 = streams[dest]
                with cv:
                    store["chunks"].setdefault((m, dest), []).append(c0)
                    cv.notify_all()
                sched.yield_point(f"chunk0-durable-d{dest}")
                if bug == "torn_chunk_install" and m == 0 and dest == torn_dest:
                    # torn stream: the second chunk and the manifest never
                    # land, yet this donor still acks below
                    continue
                with cv:
                    store["chunks"][(m, dest)].append(c1)
                    cv.notify_all()
                sched.yield_point(f"chunk1-durable-d{dest}")
                with cv:
                    store["chunk_manifest"][(m, dest)] = 2
                    cv.notify_all()

        def read_imports(m: int) -> tuple:
            """Assemble this rank's imports from the chunk streams addressed
            to it. Complete-or-abort: a stream whose manifest is missing or
            overstates its chunks contributes NOTHING (the buggy installer
            under ``torn_chunk_install`` trusts partial streams instead)."""
            imports: Dict[int, "set[str]"] = {}
            imported_emitted: Dict[int, bool] = {}
            with cv:
                for (donor, dest), chunks in store["chunks"].items():
                    if dest != m:
                        continue
                    promised = store["chunk_manifest"].get((donor, dest))
                    if promised is None or len(chunks) < promised:
                        if bug != "torn_chunk_install":
                            continue  # abort the incomplete stream atomically
                    for chunk in chunks:
                        for slot, toks in chunk["slots"].items():
                            imports.setdefault(slot, set()).update(toks)
                        for slot, em in chunk.get("emitted", {}).items():
                            imported_emitted[slot] = (
                                imported_emitted.get(slot, False) or em
                            )
            return imports, imported_emitted

        def install(m: int) -> None:
            """Adopt epoch + ownership map + imported fragments atomically
            (purging parked future frames into the live inbox)."""
            me = members[m]
            target = {s for s in range(n_slots) if new_owner(s) == m}
            imports, imported_emitted = read_imports(m)
            with me.cv:
                me.epoch = new_epoch
                if bug == "epoch_before_install" and m == 0:
                    # the planted regression: the epoch (and traffic) move
                    # while the ownership map still reflects the OLD topology
                    pass
                elif bug == "double_owner" and m == 0:
                    me.owned = me.owned | target  # never releases donated slots
                    for slot, toks in imports.items():
                        me.tokens.setdefault(slot, set()).update(toks)
                    me.emitted.update(imported_emitted)
                else:
                    for slot in list(me.owned - target):
                        me.owned.discard(slot)
                        me.tokens.pop(slot, None)
                    me.owned = set(target)
                    for slot, toks in imports.items():
                        me.tokens.setdefault(slot, set()).update(toks)
                    me.emitted.update(imported_emitted)
                keep = [(e, s, t) for (e, s, t) in me.parked if e == new_epoch]
                me.stale_dropped += len(me.parked) - len(keep)
                me.inbox.extend(keep)
                me.parked = []
                me.cv.notify_all()

        def late_map_fix(m: int) -> None:
            """epoch_before_install only: the map catches up after traffic
            already ran at the new epoch."""
            me = members[m]
            target = {s for s in range(n_slots) if new_owner(s) == m}
            imports, imported_emitted = read_imports(m)
            with me.cv:
                for slot in list(me.owned - target):
                    me.owned.discard(slot)
                    me.tokens.pop(slot, None)
                me.owned = set(target)
                for slot, toks in imports.items():
                    me.tokens.setdefault(slot, set()).update(toks)
                me.emitted.update(imported_emitted)
                me.cv.notify_all()

        def traffic(m: int) -> None:
            """Post-install: route one row per moved slot to its owner under
            MY current map, stamped with MY epoch."""
            me = members[m]
            with me.cv:
                epoch = me.epoch
                stale_map = (
                    bug == "epoch_before_install" and m == 0
                    and me.owned == init_owned.get(0, set())
                )
            for slot in sorted(moved):
                dest = old_owner(slot) if stale_map else new_owner(slot)
                if dest == m:
                    continue
                target = members[dest]
                if target.released:
                    with cv:
                        store["misrouted"].append((slot, dest))
                        cv.notify_all()
                    continue
                target.on_frame(epoch, slot, f"routed{slot}from{m}")
            with cv:
                store["traffic_done"] += 1
                cv.notify_all()
            notify_everyone()

        def drain(m: int) -> None:
            """Deliver inbox rows until every new member finished sending and
            nothing is left queued here."""
            me = members[m]
            while True:
                with me.cv:
                    while me.inbox:
                        frame_epoch, slot, token = me.inbox.pop(0)
                        me.delivered.append((frame_epoch, me.epoch, slot))
                        if slot not in me.owned:
                            me.bad_rows.append((slot, token))
                        else:
                            me.tokens.setdefault(slot, set()).add(token)
                    with cv:
                        done = store["traffic_done"] >= len(members_after)
                    if done and not me.inbox:
                        return
                    me.cv.wait()

        def old_member_body(m: int) -> None:
            me = members[m]
            # 0. pre-cut serving: the join emits each owned slot's match
            #    (bookkeeping recorded, to ride the fragments)
            emit_matches(m)
            # 1. quiesce: every old member votes ready at the commit boundary
            with cv:
                store["ready"].add(m)
                cv.notify_all()
                while len(store["ready"]) < old_n:
                    cv.wait()
            # 2. handoff fragments (per-slot state partitioned by NEW owner)
            if bug == "release_before_drain" and m in leavers:
                # the planted regression: the leaver tears down before its
                # fragments are durable — its slots' rows are simply gone
                # (it still acks, hiding the loss until the check)
                with me.cv:
                    me.released = True
                    me.owned.clear()
                    me.tokens.clear()
                with cv:
                    store["acks"].add(m)
                    cv.notify_all()
                return
            write_fragments(m)
            sched.yield_point("fragments-durable")
            # 3. durability-ack barrier
            with cv:
                store["acks"].add(m)
                cv.notify_all()
                while len(store["acks"]) < old_n:
                    cv.wait()
            # 4. rank 0 commits the single membership manifest (check-and-
            #    write under one lock; at-most-one by construction)
            if m == 0:
                with lock:
                    if not any(x[0] == "member" for x in store["manifests"]):
                        store["manifests"].append(("member", old_n, new_n))
                with cv:
                    cv.notify_all()
            with cv:
                while not store["manifests"]:
                    cv.wait()
            # 5. leavers release only now: fragments durable AND manifest
            #    committed (their journal shard is drained by construction)
            if m in leavers:
                with me.cv:
                    me.released = True
                    me.owned.clear()
                    me.tokens.clear()
                notify_everyone()
                return
            # 6. survivors install (epoch + map + imports, atomically),
            #    re-check the join (imported bookkeeping suppresses
            #    re-emission), then run post-install traffic and drain
            install(m)
            emit_matches(m)
            traffic(m)
            if bug == "epoch_before_install" and m == 0:
                late_map_fix(m)
            drain(m)

        def joiner_body(j: int) -> None:
            me = members[j]
            # joiners wait for the committed manifest (their catch-up is the
            # manifest + fragments, never a history replay), then install
            with cv:
                while not store["manifests"]:
                    cv.wait()
            install(j)
            emit_matches(j)
            traffic(j)
            drain(j)

        for m in range(old_n):
            sched.spawn(old_member_body, m, name=f"member{m}")
        for j in joiners:
            sched.spawn(joiner_body, j, name=f"joiner{j}")

        def check() -> None:
            # every slot owned by exactly one live member, and by the mapped one
            for slot in range(n_slots):
                owners = [
                    mm.rank for mm in members.values()
                    if slot in mm.owned and not mm.released
                ]
                assert len(owners) == 1, (
                    f"slot {slot} owned by {owners} (expected exactly one "
                    "owner at the final epoch)"
                )
                assert owners[0] == new_owner(slot), (
                    f"slot {slot} owned by rank {owners[0]}, expected "
                    f"{new_owner(slot)}"
                )
            # rows reside ONLY with their slot's owner under the committed
            # map (a stale partition map lands them elsewhere)
            for mm in members.values():
                if mm.released:
                    continue
                for slot, toks in mm.tokens.items():
                    base = {t for t in toks if not t.startswith("routed")}
                    assert not base or mm.rank == new_owner(slot), (
                        f"slot {slot} rows reside on rank {mm.rank} but the "
                        f"committed map owns it to rank {new_owner(slot)} "
                        "(stale owner map at partition time?)"
                    )
            # no row lost or duplicated across the handoff — including both
            # join arrangement sides
            for slot in range(n_slots):
                want = {
                    f"row{slot}a", f"row{slot}b",
                    f"jleft{slot}", f"jright{slot}",
                }
                held: "set[str]" = set()
                for mm in members.values():
                    if mm.released:
                        continue
                    base = {
                        t for t in mm.tokens.get(slot, set())
                        if not t.startswith("routed")
                    }
                    assert not (held & base), (
                        f"slot {slot} rows duplicated across ranks: {held & base}"
                    )
                    held |= base
                assert held == want, (
                    f"slot {slot} rows lost across the handoff: have "
                    f"{sorted(held)}, want {sorted(want)}"
                )
            assert not store["misrouted"], (
                f"rows routed to released leavers: {store['misrouted']}"
            )
            for m in members_after:
                mm = members[m]
                assert mm.epoch == new_epoch, f"rank {m} never adopted the epoch"
                assert not mm.parked, f"rank {m} stranded parked frames"
                for frame_epoch, at_epoch, slot in mm.delivered:
                    assert frame_epoch == at_epoch, (
                        f"stale-epoch delivery on rank {m} (slot {slot}; "
                        f"{mm.stale_dropped} other stale frames were dropped "
                        "correctly)"
                    )
                assert not mm.bad_rows, (
                    f"rows delivered to a non-owner on rank {m}: {mm.bad_rows}"
                )
            for lv in leavers:
                assert members[lv].released, f"leaver {lv} never released"
            assert (
                len([x for x in store["manifests"] if x[0] == "member"]) == 1
            ), "membership manifest committed more than once (or never)"
            # every join match emitted exactly once — the bookkeeping riding
            # the fragments must suppress re-emission after install
            for slot in range(n_slots):
                n_emitted = store["matches"].count(f"match{slot}")
                assert n_emitted == 1, (
                    f"slot {slot} match emitted {n_emitted} time(s) — the "
                    "join replayed (or lost) a match across the cut"
                )
            # chunk streams complete-or-abort: a committed manifest never
            # overstates the chunks that actually landed
            for (donor, dest), promised in store["chunk_manifest"].items():
                got = len(store["chunks"].get((donor, dest), []))
                assert got == promised, (
                    f"chunk stream {donor}->{dest} committed a manifest for "
                    f"{promised} chunk(s) but {got} landed"
                )

        return check

    return model


# ---------------------------------------------------------------------------
# tiered IVF index: prefetch staging / background rebuild / generation swap
# ---------------------------------------------------------------------------


def tiered_index_model(
    *,
    n_clusters: int = 3,
    n_reads: int = 4,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The tiered-index residency protocol (``ops/knn_tiers.py``), modeled
    BEFORE the real threads were wired (model first, then wire): reader threads
    serve queries against the current generation (coarse probe reads the
    centroids, scoring reads the cluster pages — BOTH under one lock hold,
    the commit-boundary atomicity the engine thread gets for free); a
    prefetch worker stages cold clusters hot (taking a staging slot, doing
    the H2D work off-lock, releasing the slot on every path); a background
    rebuilder builds the next generation's pages off to the side and SWAPS —
    centroids and pages re-point together, only after every cluster of the
    new generation is built, with the old generation's pages intact until
    the instant the swap commits.

    Invariants over every interleaving: no torn read (a query never mixes
    generation-g centroids with generation-g' pages, and never reads an
    incomplete or missing page set); the swap happens exactly once and only
    after the new generation is complete; staging slots always return to
    zero; no deadlock.

    Planted bugs (each must be CAUGHT with a replayable schedule):
    ``"torn_swap"`` — the swap publishes centroids and pages in two lock
    acquisitions, so a reader between them mixes generations;
    ``"swap_incomplete"`` — the rebuilder swaps after building only part of
    the new generation (queries hit missing clusters);
    ``"drop_old_early"`` — the rebuilder frees the old generation's pages
    before the swap commits (in-flight queries read freed pages);
    ``"leak_stage"`` — the prefetcher skips the staging-slot release when a
    swap invalidated its target mid-stage (the slot-leak class behind a
    permanently-wedged promotion pipeline)."""

    new_gen = 1

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("index")
        cv = sched.condition(lock, name="index.cv")
        state: Dict[str, Any] = {
            "centroids_gen": 0,
            "pages_gen": 0,
            # generation -> set of built cluster ids (complete == n_clusters)
            "pages": {0: set(range(n_clusters))},
            "hot": set(),
            "staging": 0,
            "swaps": 0,
            "reads": [],  # (centroids_gen, pages_gen, missing_clusters)
            "rebuild_done": False,
            "readers_done": 0,
        }

        def reader_body(idx: int) -> None:
            for _ in range(n_reads):
                with cv:
                    cg = state["centroids_gen"]
                    pg = state["pages_gen"]
                    built = state["pages"].get(pg, set())
                    missing = n_clusters - len(built)
                    state["reads"].append((cg, pg, missing))
                sched.yield_point(f"reader{idx}")
            with cv:
                state["readers_done"] += 1
                cv.notify_all()

        def prefetcher_body() -> None:
            for cid in range(n_clusters):
                with cv:
                    gen_at_start = state["pages_gen"]
                    if cid not in state["pages"].get(gen_at_start, set()):
                        continue
                    state["staging"] += 1
                sched.yield_point("stage")  # the off-lock H2D / unspill work
                with cv:
                    invalidated = state["pages_gen"] != gen_at_start
                    if invalidated and bug == "leak_stage":
                        # the planted leak: an invalidated stage abandons its
                        # slot instead of releasing it on the way out
                        continue
                    state["staging"] -= 1
                    if not invalidated:
                        state["hot"].add(cid)
                    cv.notify_all()

        def rebuilder_body() -> None:
            built: set = set()
            target = (
                range(n_clusters - 1)
                if bug == "swap_incomplete"
                else range(n_clusters)
            )
            for cid in target:
                sched.yield_point("build")  # off-to-the-side training work
                with cv:
                    built.add(cid)
                    state["pages"].setdefault(new_gen, set()).add(cid)
            if bug == "drop_old_early":
                # the planted regression: the old generation is freed BEFORE
                # the swap commits — in-flight readers lose their pages
                with cv:
                    state["pages"][0] = set()
            sched.yield_point("pre-swap")
            if bug == "torn_swap":
                # two lock acquisitions: a reader between them mixes gens
                with cv:
                    state["centroids_gen"] = new_gen
                sched.yield_point("swap-gap")
                with cv:
                    state["pages_gen"] = new_gen
                    state["swaps"] += 1
                    state["rebuild_done"] = True
                    cv.notify_all()
            else:
                with cv:
                    state["centroids_gen"] = new_gen
                    state["pages_gen"] = new_gen
                    state["swaps"] += 1
                    state["rebuild_done"] = True
                    cv.notify_all()

        for idx in range(2):
            sched.spawn(reader_body, idx, name=f"reader{idx}")
        sched.spawn(prefetcher_body, name="prefetch")
        sched.spawn(rebuilder_body, name="rebuild")

        def check() -> None:
            for cg, pg, missing in state["reads"]:
                assert cg == pg, (
                    f"torn generation read: centroids from generation {cg} "
                    f"scored against generation-{pg} pages"
                )
                assert missing == 0, (
                    f"query read an incomplete generation: {missing} cluster "
                    f"page set(s) missing from generation {pg}"
                )
            assert state["staging"] == 0, (
                f"staging slots leaked: {state['staging']} still held after "
                "every stage terminated"
            )
            assert state["swaps"] == 1, (
                f"generation swap committed {state['swaps']} times (expected "
                "exactly once)"
            )
            assert state["pages_gen"] == new_gen and state["centroids_gen"] == new_gen
            assert len(state["pages"].get(new_gen, set())) == n_clusters, (
                "swap committed an incomplete generation"
            )

        return check

    return model


# ---------------------------------------------------------------------------
# quantized retrieval: scale recalibration install vs concurrent scoring
# ---------------------------------------------------------------------------


def quant_recalibration_model(
    *,
    n_pages: int = 3,
    n_reads: int = 4,
    abort: bool = False,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The quantization-sidecar recalibration protocol
    (``ops/knn_tiers.py::_recalibrate_quant``), modeled before the chaos
    acceptance was wired: reader threads score pages by reading the
    (scale, codes, cached-f32-cast) triple per page under one lock hold —
    the commit-boundary atomicity a quantized score depends on, because a
    new scale applied to old codes (or a stale cached cast of old codes)
    silently mis-scores every row on the page. The recalibrator requantizes
    every page off to the side (off-lock), then either ABORTS before the
    install (the ``quant`` chaos op: nothing published, old sidecars keep
    serving) or installs scales + codes + cast-invalidation in ONE lock
    acquisition.

    Invariants over every interleaving: no torn sidecar read (a reader
    never mixes new scales with old codes or vice versa); the cached cast
    always matches the codes it was cast from; an aborted recalibration
    publishes NOTHING (serving state is bitwise the old generation); a
    completed one installs exactly once, completely; no deadlock.

    Planted bugs (each must be CAUGHT with a replayable schedule):
    ``"torn_install"`` — scales and codes install in two lock acquisitions,
    so a reader between them scores old codes at new scales;
    ``"stale_cast"`` — the install forgets to invalidate the cached f32
    cast of the codes (the real ``_qf32`` hazard), so readers score the OLD
    cast at the new scale;
    ``"install_after_abort"`` — the chaos-abort path publishes the new
    scales anyway (recovery must serve the old generation bit-exactly)."""

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("index")
        cv = sched.condition(lock, name="index.quant.cv")
        state: Dict[str, Any] = {
            # per-page sidecar versions; a consistent page has all three equal
            "scales_ver": [0] * n_pages,
            "codes_ver": [0] * n_pages,
            "cast_ver": [0] * n_pages,
            "installs": 0,
            "aborts": 0,
            "reads": [],  # (page, scales_ver, codes_ver, cast_ver)
            "readers_done": 0,
        }

        def reader_body(idx: int) -> None:
            for r in range(n_reads):
                page = (idx + r) % n_pages
                with cv:
                    state["reads"].append(
                        (
                            page,
                            state["scales_ver"][page],
                            state["codes_ver"][page],
                            state["cast_ver"][page],
                        )
                    )
                sched.yield_point(f"reader{idx}")
            with cv:
                state["readers_done"] += 1
                cv.notify_all()

        def recalibrator_body() -> None:
            for _page in range(n_pages):
                sched.yield_point("requantize")  # off-lock scale+code rebuild
            if abort:
                # the chaos `quant` op fires before the install: the new
                # sidecars are dropped on the floor, old scales keep serving
                with cv:
                    state["aborts"] += 1
                    if bug == "install_after_abort":
                        # planted: the abort path publishes anyway
                        for page in range(n_pages):
                            state["scales_ver"][page] = 1
                    cv.notify_all()
                return
            sched.yield_point("pre-install")
            if bug == "torn_install":
                # two lock acquisitions: a reader between them scores old
                # codes at new scales
                with cv:
                    for page in range(n_pages):
                        state["scales_ver"][page] = 1
                sched.yield_point("install-gap")
                with cv:
                    for page in range(n_pages):
                        state["codes_ver"][page] = 1
                        state["cast_ver"][page] = 1
                    state["installs"] += 1
                    cv.notify_all()
            else:
                with cv:
                    for page in range(n_pages):
                        state["scales_ver"][page] = 1
                        state["codes_ver"][page] = 1
                        if bug != "stale_cast":
                            state["cast_ver"][page] = 1
                    state["installs"] += 1
                    cv.notify_all()

        for idx in range(2):
            sched.spawn(reader_body, idx, name=f"reader{idx}")
        sched.spawn(recalibrator_body, name="recalibrate")

        def check() -> None:
            for page, sv, codv, castv in state["reads"]:
                assert sv == codv, (
                    f"torn sidecar read on page {page}: generation-{sv} "
                    f"scales applied to generation-{codv} codes"
                )
                assert castv == codv, (
                    f"stale cached cast on page {page}: generation-{codv} "
                    f"codes scored through a generation-{castv} f32 cast"
                )
            # the cast invariant also holds at quiescence: a stale cache is
            # a latent mis-score even if no read raced the install
            for page in range(n_pages):
                assert state["cast_ver"][page] == state["codes_ver"][page], (
                    f"stale cached cast on page {page}: generation-"
                    f"{state['codes_ver'][page]} codes left behind a "
                    f"generation-{state['cast_ver'][page]} f32 cast"
                )
            if abort:
                assert state["installs"] == 0 and state["aborts"] == 1
                assert all(v == 0 for v in state["scales_ver"]), (
                    "aborted recalibration published new scales — recovery "
                    "must serve the old sidecars bit-exactly"
                )
            else:
                assert state["installs"] == 1, (
                    f"recalibration installed {state['installs']} times "
                    "(expected exactly once)"
                )
                assert all(v == 1 for v in state["scales_ver"])
                assert all(v == 1 for v in state["codes_ver"])

        return check

    return model


# ---------------------------------------------------------------------------
# closed-loop autoscaler: sample -> decide -> directive -> transition outcome
# ---------------------------------------------------------------------------


def autoscaler_model(
    *,
    ticks: int = 10,
    high_ticks: int = 6,
    cooldown: int = 3,
    backoff: int = 4,
    refuse_up: bool = False,
    crash_up: bool = False,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The autoscale control loop (``parallel/autoscaler.py``) against the
    membership-transition executor (the supervisor's ``request_scale`` /
    ``_watch_transition`` path), modeled BEFORE the real controller was wired
    (model first, then wire). A controller thread ticks ``ticks`` times over a
    scripted load profile (overload for the first ``high_ticks`` ticks, idle
    after), engaging the brownout rung FIRST and only then deciding scale
    directions; an executor thread consumes issued directives and either
    completes them, REFUSES the first scale-up (``refuse_up`` — the preflight
    vote), or dies mid-flight (``crash_up`` — the manifest committed, so the
    recovery thread brings the cluster back STABLE at the new topology).
    Model time is the controller's tick counter, so cooldown/backoff windows
    are exact whatever the interleaving.

    Invariants over every interleaving: never two transitions in flight (a
    directive is only issued with none active), consecutive directives
    respect the cooldown window, a refused scale-up is never retried inside
    its backoff window (at most one retry per window), every overload-driven
    scale-up is preceded by a brownout engage (shed first, scale second), no
    directive is issued while the cluster is recovering from the mid-flight
    crash, and the protocol never deadlocks.

    Planted bugs (each must be CAUGHT with a replayable schedule):
    ``"double_directive"`` — the controller skips the in-flight check, so a
    slow transition overlaps a second directive; ``"cooldown_skip"`` — the
    cooldown gate is dropped, back-to-back directives storm the transition
    path; ``"refusal_retry"`` — the refusal backoff is ignored, the refused
    scale-up is hammered every eligible tick; ``"no_shed_first"`` — the
    controller scales on overload without engaging the brownout rung."""

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("autoscale")
        cv = sched.condition(lock, name="autoscale.cv")
        state: Dict[str, Any] = {
            "n": 1,
            "cluster": "stable",  # stable | recovering
            "in_flight": 0,
            "queue": [],  # (issue_tick, direction, target)
            "issued": [],  # (issue_tick, direction, target)
            "completed": [],
            "refusals": [],  # (issue_tick, target)
            "refused": None,  # pending feedback for the controller
            "backoff_until": None,
            "last_issue_tick": None,
            "brownout": 0,
            "events": [],  # ordered: ("brownout"|"issue_up"|"issue_down"|"refusal_backoff", tick)
            "overlap": 0,  # directives issued while one was in flight
            "unstable_issue": 0,  # directives issued while recovering
            "crashed": False,
            "recover_to": None,
            "done": False,
        }

        def controller_body() -> None:
            for tick in range(ticks):
                pressure = 2 if tick < high_ticks else 0
                with cv:
                    if state["refused"] is not None:
                        state["refused"] = None
                        state["backoff_until"] = tick + backoff
                        state["events"].append(("refusal_backoff", tick))
                    # shed first: the brownout rung engages before any scale
                    # decision is even considered
                    if bug != "no_shed_first":
                        if pressure >= 2 and state["brownout"] == 0:
                            state["brownout"] = 1
                            state["events"].append(("brownout", tick))
                        elif pressure <= 0:
                            state["brownout"] = 0
                    direction = None
                    if pressure >= 2 and (
                        state["brownout"] > 0 or bug == "no_shed_first"
                    ):
                        direction = "up"
                    elif pressure <= 0 and state["n"] > 1:
                        direction = "down"
                    issue = direction is not None
                    if issue and state["in_flight"] > 0 and bug != "double_directive":
                        issue = False
                    if issue and state["cluster"] != "stable":
                        issue = False
                    if (
                        issue
                        and bug != "cooldown_skip"
                        and state["last_issue_tick"] is not None
                        and tick - state["last_issue_tick"] < cooldown
                    ):
                        issue = False
                    if (
                        issue
                        and direction == "up"
                        and bug != "refusal_retry"
                        and state["backoff_until"] is not None
                        and tick < state["backoff_until"]
                    ):
                        issue = False
                    if issue:
                        if state["in_flight"] > 0:
                            state["overlap"] += 1
                        if state["cluster"] != "stable":
                            state["unstable_issue"] += 1
                        target = state["n"] + (1 if direction == "up" else -1)
                        state["in_flight"] += 1
                        state["last_issue_tick"] = tick
                        state["queue"].append((tick, direction, target))
                        state["issued"].append((tick, direction, target))
                        state["events"].append((f"issue_{direction}", tick))
                        cv.notify_all()
                sched.yield_point(f"tick{tick}")
            with cv:
                state["done"] = True
                cv.notify_all()

        def executor_body() -> None:
            refused_once = False
            while True:
                with cv:
                    while not state["queue"]:
                        if state["done"]:
                            return
                        cv.wait()
                    issue_tick, direction, target = state["queue"].pop(0)
                sched.yield_point("transition")
                with cv:
                    if refuse_up and direction == "up" and not refused_once:
                        # the preflight capability vote: typed refusal, the
                        # cluster keeps running at its current size
                        refused_once = True
                        state["refused"] = (target, "non-reshardable state")
                        state["refusals"].append((issue_tick, target))
                    elif crash_up and direction == "up" and not state["crashed"]:
                        # mid-flight death AFTER the manifest committed: the
                        # recovery ladder owns the cluster until it restarts
                        # everyone at the committed topology
                        state["crashed"] = True
                        state["cluster"] = "recovering"
                        state["recover_to"] = target
                    else:
                        state["n"] = target
                        state["completed"].append((issue_tick, direction, target))
                    state["in_flight"] -= 1
                    cv.notify_all()

        def recovery_body() -> None:
            with cv:
                while state["cluster"] != "recovering":
                    if state["done"] and not state["queue"] and state["in_flight"] == 0:
                        return
                    cv.wait()
            sched.yield_point("recovering")
            with cv:
                state["n"] = state["recover_to"]
                state["cluster"] = "stable"
                cv.notify_all()

        sched.spawn(controller_body, name="controller")
        sched.spawn(executor_body, name="executor")
        if crash_up:
            sched.spawn(recovery_body, name="recovery")

        def check() -> None:
            assert state["overlap"] == 0, (
                f"two membership transitions in flight: {state['overlap']} "
                f"directive(s) issued while one was active ({state['issued']})"
            )
            assert state["unstable_issue"] == 0, (
                "directive issued while the cluster was recovering from a "
                "mid-flight crash"
            )
            issue_ticks = [t for (t, _d, _n) in state["issued"]]
            for t1, t2 in zip(issue_ticks, issue_ticks[1:]):
                assert t2 - t1 >= cooldown, (
                    f"cooldown violated: directives at ticks {t1} and {t2} "
                    f"(window {cooldown})"
                )
            # refusal backoff: no scale-up inside (observation, observation+backoff)
            for kind, r_obs in state["events"]:
                if kind != "refusal_backoff":
                    continue
                storm = [
                    t
                    for (t, d, _n) in state["issued"]
                    if d == "up" and r_obs <= t < r_obs + backoff
                ]
                assert not storm, (
                    f"refused scale-up retried inside its backoff window "
                    f"(refusal observed at tick {r_obs}, retries at {storm})"
                )
            # shed before scale: the first overload scale-up must be preceded
            # by a brownout engage in the event order
            seq = state["events"]
            first_up = next(
                (i for i, (k, _t) in enumerate(seq) if k == "issue_up"), None
            )
            if first_up is not None:
                assert any(k == "brownout" for k, _t in seq[:first_up]), (
                    "scale-up issued before the brownout rung engaged "
                    "(shed-first ordering violated)"
                )
            if crash_up and state["crashed"]:
                assert state["cluster"] == "stable", (
                    "cluster never recovered from the mid-flight crash"
                )
                assert state["n"] >= state["recover_to"] or not [
                    1 for (_t, d, _n) in state["completed"] if d == "down"
                ], "recovery lost the committed topology"
            assert 1 <= state["n"] <= 1 + len(
                [1 for (_t, d, _n) in state["issued"] if d == "up"]
            ), f"worker count escaped its bounds: n={state['n']}"

        return check

    return model


# ---------------------------------------------------------------------------
# read-replica bootstrap / follow / bounded-staleness serve (parallel/replica.py)
# ---------------------------------------------------------------------------


def replica_follow_model(
    n_commits: int = 4,
    n_clients: int = 2,
    *,
    lag_bound: int = 1,
    torn: bool = False,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The read-replica follow protocol (``parallel/replica.py``), modeled
    BEFORE the fleet was wired (model first, then wire). Staleness is measured
    in COMMITS (model time — no wall clock): a primary thread exports frames
    1..``n_commits``; a bootstrap thread installs the snapshot (or refuses it
    typed when ``torn``); TWO poller threads race the frame tail — the exact
    race the exactly-once apply guard exists for; client threads each issue
    one query with a ``lag_bound`` staleness bound and either serve at the
    applied commit or shed.

    Invariants over every interleaving: every frame is applied EXACTLY once
    and in commit order; every serve happens at lag <= ``lag_bound`` at the
    instant of serving; a torn bootstrap never serves a single query (the
    replica refuses typed and stays out of rotation); every client query is
    shed XOR answered; the follower converges to the feed tip; and the
    protocol never deadlocks.

    Planted bugs (each must be CAUGHT with a replayable schedule):
    ``"double_apply"`` — the commit-id guard is dropped, so racing pollers
    apply one frame twice (the regression class that breaks bitwise replica/
    primary parity); ``"stale_serve"`` — the staleness bound is not checked
    at serve time, so a lagging replica answers beyond the client's bound;
    ``"torn_bootstrap_serve"`` — the torn-bootstrap refusal is swallowed and
    the replica serves from a half-installed index."""

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("replica")
        cv = sched.condition(lock, name="replica.cv")
        state: Dict[str, Any] = {
            "tip": 0,  # latest commit the primary exported a frame for
            "done": False,  # primary finished exporting
            "bootstrapped": False,
            "refused": False,
            "applied": 0,  # the follower's applied commit id
            "applied_log": [],  # every frame application, in order
            "serves": [],  # (served_commit, tip_at_serve)
            "sheds": 0,
            "outcomes": 0,  # terminal client outcomes (serve XOR shed)
        }

        def primary_body() -> None:
            for commit in range(1, n_commits + 1):
                with cv:
                    state["tip"] = commit
                    cv.notify_all()
                sched.yield_point(f"export{commit}")
            with cv:
                state["done"] = True
                cv.notify_all()

        def bootstrap_body() -> None:
            sched.yield_point("read_manifest")
            with cv:
                if torn and bug != "torn_bootstrap_serve":
                    # checksum mismatch on a fragment: TYPED refusal, the
                    # replica never enters rotation
                    state["refused"] = True
                else:
                    # (with the planted bug, a torn export installs anyway)
                    state["bootstrapped"] = True
                cv.notify_all()

        def poller_body(idx: int) -> None:
            while True:
                with cv:
                    while True:
                        if state["refused"]:
                            return
                        if state["bootstrapped"] and state["applied"] < state["tip"]:
                            break
                        if state["done"] and (
                            state["bootstrapped"] or state["refused"]
                        ):
                            if state["applied"] >= state["tip"]:
                                return
                            break
                        cv.wait()
                    floor = state["applied"]
                    frames = list(range(floor + 1, state["tip"] + 1))
                # frames are READ outside the apply lock, one at a time — the
                # window in which the other poller may already have applied them
                for commit in frames:
                    sched.yield_point(f"p{idx}.read{commit}")
                    with cv:
                        if bug != "double_apply" and commit <= state["applied"]:
                            continue  # the exactly-once guard
                        state["applied_log"].append(commit)
                        state["applied"] = max(state["applied"], commit)
                        cv.notify_all()

        def client_body(q: int) -> None:
            sched.yield_point(f"q{q}.arrive")
            with cv:
                while not (state["bootstrapped"] or state["refused"]):
                    cv.wait()
                if state["refused"]:
                    # out of rotation: the router fails over — a shed outcome
                    # from this replica's perspective, never an answer
                    state["sheds"] += 1
                    state["outcomes"] += 1
                    cv.notify_all()
                    return
                lag = state["tip"] - state["applied"]
                if lag > lag_bound and bug != "stale_serve":
                    state["sheds"] += 1
                else:
                    state["serves"].append((state["applied"], state["tip"]))
                state["outcomes"] += 1
                cv.notify_all()

        sched.spawn(primary_body, name="primary")
        sched.spawn(bootstrap_body, name="bootstrap")
        for i in range(2):
            sched.spawn(poller_body, i, name=f"poller{i}")
        for q in range(n_clients):
            sched.spawn(client_body, q, name=f"client{q}")

        def check() -> None:
            log = state["applied_log"]
            assert len(log) == len(set(log)), (
                f"frame applied twice (bitwise parity broken): {log}"
            )
            assert log == sorted(log), f"frames applied out of order: {log}"
            if torn:
                assert not state["serves"], (
                    "torn bootstrap served queries from a half-installed "
                    f"index: {state['serves']}"
                )
            else:
                assert state["applied"] == n_commits, (
                    f"follower never converged to the feed tip: applied "
                    f"{state['applied']} of {n_commits}"
                )
            for served_commit, tip_at in state["serves"]:
                assert tip_at - served_commit <= lag_bound, (
                    f"served {tip_at - served_commit} commit(s) stale, past "
                    f"the bound {lag_bound} (serve at commit {served_commit} "
                    f"with tip {tip_at})"
                )
            assert state["outcomes"] == n_clients, (
                f"client query stranded with no outcome: "
                f"{state['outcomes']}/{n_clients} terminal"
            )

        return check

    return model


# ---------------------------------------------------------------------------
# trace ring / pending-buffer protocol (engine/tracing.py)
# ---------------------------------------------------------------------------


def trace_ring_model(
    n_writers: int = 2,
    n_traces: int = 2,
    *,
    ring_cap: int = 8,
    bug: Optional[str] = None,
) -> Callable[[DeterministicScheduler], Callable[[], None]]:
    """The tracing plane's span-routing protocol (``engine/tracing.py``):
    the bounded ring, the pending buffer unsampled spans wait in until
    their root's slow-promotion verdict, the epoch bump an elastic
    membership change installs mid-flight, and the crash flush the flight
    recorder drives from a dying rank.

    Threads: ``n_writers`` span writers each start+finish one span per
    trace (the SAME trace ids cross writers — one cross-rank trace whose
    sampling verdict every rank must derive identically); an epoch
    installer bumps the epoch between any two steps; a crash thread flushes
    the ring concurrently (the SIGTERM flight-dump path — file lock, then
    ring lock, the one canonical order).

    Invariants over every interleaving: **span conservation** — every span
    a writer starts terminates in the ring or the accounted drop list, so
    an epoch bump never orphans a buffered span; **flush-on-crash never
    deadlocks** — the crash flush and writer promotion take the file and
    ring locks in one global order; **sampling is consistent across a
    trace** — the head decision is a pure function of the trace id, so no
    trace ends half-kept, half-dropped across ranks; the flush completes
    exactly once.

    Planted bugs (each must be CAUGHT with a replayable schedule):
    ``"orphan_on_bump"`` — the epoch installer clears the pending buffer
    unaccounted, stranding in-flight spans; ``"flush_deadlock"`` — writer
    promotion grabs the file lock while holding the ring lock (the AB/BA
    inversion with the crash flush); ``"split_sampling"`` — each writer
    flips its own per-rank coin instead of hashing the trace id."""

    def model(sched: DeterministicScheduler) -> Callable[[], None]:
        lock = sched.lock("trace.ring")
        cv = sched.condition(lock, name="trace.cv")
        file_lock = sched.lock("trace.file")
        state: Dict[str, Any] = {
            "epoch": 0,
            "ring": [],  # (trace, writer, epoch_at_start) — kept spans
            "pending": {},  # trace -> [(writer, epoch_at_start)] buffered
            "dropped": [],  # ("unsampled"|"evicted", trace, writer, epoch)
            "started": 0,
            "finished": 0,
            "flushes": [],  # ring snapshots the crash flush captured
        }

        def _route_locked(trace: int, w: int, sampled: bool) -> None:
            # promotion verdict: pop THIS writer's buffered entries for the
            # trace and route them — ring (evicting over cap, accounted) or
            # the drop list; nothing may vanish silently
            bucket = state["pending"].get(trace, [])
            mine = [e for e in bucket if e[0] == w]
            state["pending"][trace] = [e for e in bucket if e[0] != w]
            for writer, epoch_at in mine:
                if sampled:
                    state["ring"].append((trace, writer, epoch_at))
                    if len(state["ring"]) > ring_cap:
                        state["dropped"].append(
                            ("evicted",) + state["ring"].pop(0)
                        )
                else:
                    state["dropped"].append(
                        ("unsampled", trace, writer, epoch_at)
                    )
            state["finished"] += len(mine)
            cv.notify_all()

        def writer_body(w: int) -> None:
            for trace in range(n_traces):
                with cv:
                    epoch_at_start = state["epoch"]
                    state["started"] += 1
                    state["pending"].setdefault(trace, []).append(
                        (w, epoch_at_start)
                    )
                    cv.notify_all()
                sched.yield_point(f"w{w}.t{trace}.work")
                if bug == "split_sampling":
                    # each rank flips its own coin — the exact divergence
                    # the hash-of-trace-id decision function exists to bar
                    sampled = (trace + w) % 2 == 0
                else:
                    # pure function of the trace id: every rank agrees
                    sampled = trace % 2 == 0
                if bug == "flush_deadlock":
                    with cv:
                        sched.yield_point(f"w{w}.t{trace}.inverted")
                        # ring lock held, file lock wanted: AB/BA against
                        # the crash flush's file-then-ring order
                        with file_lock:
                            _route_locked(trace, w, sampled)
                else:
                    with cv:
                        _route_locked(trace, w, sampled)

        def installer_body() -> None:
            sched.yield_point("bump.arrive")
            with cv:
                state["epoch"] += 1
                if bug == "orphan_on_bump":
                    # the regression: "stale" buffers swept on bump — any
                    # span between its start and its root's verdict vanishes
                    state["pending"].clear()
                cv.notify_all()

        def crash_body() -> None:
            sched.yield_point("crash.arrive")
            with file_lock:
                sched.yield_point("crash.flush")
                with cv:
                    state["flushes"].append(list(state["ring"]))
                    cv.notify_all()

        for w in range(n_writers):
            sched.spawn(writer_body, w, name=f"writer{w}")
        sched.spawn(installer_body, name="installer")
        sched.spawn(crash_body, name="crash")

        def check() -> None:
            expected = n_writers * n_traces
            assert state["started"] == expected
            total = len(state["ring"]) + len(state["dropped"])
            assert total == state["started"] and (
                state["finished"] == state["started"]
            ), (
                f"span orphaned: started {state['started']}, ring+dropped "
                f"{total}, finished {state['finished']} — an epoch bump "
                "stranded a buffered span"
            )
            leftovers = [
                entry
                for bucket in state["pending"].values()
                for entry in bucket
            ]
            assert not leftovers, f"spans left buffered: {leftovers}"
            ringed = {trace for (trace, _, _) in state["ring"]}
            for drop in state["dropped"]:
                if drop[0] == "evicted":
                    ringed.add(drop[1])
            unsampled = {
                drop[1] for drop in state["dropped"] if drop[0] == "unsampled"
            }
            split = sorted(ringed & unsampled)
            assert not split, (
                f"sampling split across ranks for trace(s) {split}: one rank "
                "kept the trace, another dropped it"
            )
            assert len(state["flushes"]) == 1, (
                f"crash flush ran {len(state['flushes'])} time(s), not once"
            )

        return check

    return model


# ---------------------------------------------------------------------------
# planted lock-order inversion (the PWA101 <-> model-check bridge)
# ---------------------------------------------------------------------------


def lock_order_model(
    *, inverted: bool = False
) -> Callable[[DeterministicScheduler], Optional[Callable[[], None]]]:
    """Two threads over two locks. ``inverted=False`` is the fixed ordering
    discipline (both take A before B — never deadlocks); ``inverted=True``
    plants the classic AB/BA inversion, which deadlocks under the right
    interleaving. The same shape, written with real ``threading`` primitives,
    is what PWA101 catches statically — the model-check run is the dynamic
    proof of the same bug."""

    def model(sched: DeterministicScheduler) -> None:
        a = sched.lock("A")
        b = sched.lock("B")

        def forward() -> None:
            with a:
                sched.yield_point("between")
                with b:
                    pass

        def backward() -> None:
            first, second = (b, a) if inverted else (a, b)
            with first:
                sched.yield_point("between")
                with second:
                    pass

        sched.spawn(forward, name="forward")
        sched.spawn(backward, name="backward")
        return None

    return model
