"""The port's protocol models (``pathway_tpu_torch/internals/protocol_models.py``)
under the port's scheduler: the cases of the reference's
``tests/test_modelcheck.py`` but the PWA101 bridge (it needs the analysis
passes, which the port does not have yet), each protocol under >= 200
distinct interleavings with its invariants holding and each planted bug
caught with a replayable schedule; then parity with the reference's models:
under the same seeds and bounds the same verdict, the same number of
distinct schedules and, for each planted bug, the same failing seed and
choice sequence, which replays the failure in the port.

The acceptance batteries keep the reference's < 60 s budget, timed on the
port's runs only."""
from __future__ import annotations

import time
from typing import Dict

import pytest

from pathway_tpu_torch.internals import protocol_models as pm
from pathway_tpu_torch.internals.sched import (
    DeadlockError,
    InvariantViolation,
    explore,
    run_once,
    sweep_seeds,
)

pytestmark = pytest.mark.modelcheck

# acceptance: >= 200 distinct interleavings per protocol
N_SCHEDULES = 200

# wall seconds of the acceptance batteries, recorded by the tests themselves
# and asserted by test_model_check_battery_within_budget (runs last in file
# order) — the documented <60 s tier-1 budget is enforced, not aspirational
_BATTERY_SECONDS: Dict[str, float] = {}


# ---------------------------------------------------------------------------
# fence / rejoin
# ---------------------------------------------------------------------------


def test_fence_rejoin_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.fence_rejoin_model(2), max_schedules=N_SCHEDULES, name="fence"
    )
    _BATTERY_SECONDS["fence"] = time.monotonic() - t0
    assert result.ok, (
        f"fence/rejoin invariant failed on schedule {result.failing_schedule}: "
        f"{result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


def test_fence_rejoin_invariants_hold_seeded():
    result = sweep_seeds(
        pm.fence_rejoin_model(2), n_seeds=100, base_seed=1, name="fence-seeded"
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


def test_fence_rejoin_three_survivors():
    result = explore(pm.fence_rejoin_model(3), max_schedules=100, name="fence3")
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


def test_fence_rejoin_no_purge_bug_caught_and_replayable():
    result = explore(
        pm.fence_rejoin_model(2, bug="no_purge"),
        max_schedules=400,
        name="fence-no-purge",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the install-purge regression went undetected"
    )
    assert "stale-epoch delivery" in str(result.failure)
    # the failing schedule replays the exact interleaving
    with pytest.raises(InvariantViolation, match="stale-epoch delivery"):
        run_once(
            pm.fence_rejoin_model(2, bug="no_purge"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# coordinated checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.checkpoint_model(3), max_schedules=N_SCHEDULES, name="ckpt"
    )
    _BATTERY_SECONDS["ckpt"] = time.monotonic() - t0
    assert result.ok, (
        f"checkpoint invariant failed on schedule {result.failing_schedule}: "
        f"{result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


def test_checkpoint_invariants_hold_seeded():
    result = sweep_seeds(
        pm.checkpoint_model(3), n_seeds=100, base_seed=5, name="ckpt-seeded"
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"


def test_checkpoint_crash_leaves_previous_manifest_intact():
    # post-snapshot kill of rank 1: the ack barrier must abort on its
    # deadline and nobody may commit or compact
    result = explore(
        pm.checkpoint_model(3, crash_rank=1), max_schedules=N_SCHEDULES,
        name="ckpt-crash",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


def test_checkpoint_toctou_double_commit_caught_with_seed():
    result = sweep_seeds(
        pm.checkpoint_model(3, bug="toctou_commit"),
        n_seeds=300,
        base_seed=10,
        name="ckpt-toctou",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the manifest TOCTOU regression went undetected"
    )
    assert "double manifest commit" in str(result.failure)
    assert result.failing_seed is not None
    # the SEED alone reproduces the double commit (deterministic walk)
    with pytest.raises(InvariantViolation, match="double manifest commit"):
        run_once(
            pm.checkpoint_model(3, bug="toctou_commit"), seed=result.failing_seed
        )


# ---------------------------------------------------------------------------
# coalescer admission / shed
# ---------------------------------------------------------------------------


def test_coalescer_invariants_hold_exhaustive():
    result = explore(
        pm.coalescer_model(3, cap=2), max_schedules=N_SCHEDULES, name="coal"
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"
    assert result.distinct_schedules >= N_SCHEDULES


def test_coalescer_error_path_releases_slots():
    result = explore(
        pm.coalescer_model(3, cap=2, fail_batch=True),
        max_schedules=N_SCHEDULES,
        name="coal-err",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


def test_coalescer_slot_leak_bug_caught_and_replayable():
    result = explore(
        pm.coalescer_model(3, cap=2, fail_batch=True, bug="leak_slot"),
        max_schedules=300,
        name="coal-leak",
    )
    assert isinstance(result.failure, InvariantViolation)
    assert "admission slots leaked" in str(result.failure)
    with pytest.raises(InvariantViolation, match="admission slots leaked"):
        run_once(
            pm.coalescer_model(3, cap=2, fail_batch=True, bug="leak_slot"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# encoder service admission / tick / shutdown
# ---------------------------------------------------------------------------


@pytest.mark.encsvc
def test_encoder_service_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.encoder_service_model(3, cap=2, max_inflight=2),
        max_schedules=N_SCHEDULES,
        name="encsvc",
    )
    _BATTERY_SECONDS["encsvc"] = time.monotonic() - t0
    assert result.ok, (
        f"encoder-service invariant failed on schedule "
        f"{result.failing_schedule}: {result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.encsvc
def test_encoder_service_invariants_hold_seeded():
    result = sweep_seeds(
        pm.encoder_service_model(3, cap=2, max_inflight=2),
        n_seeds=100,
        base_seed=21,
        name="encsvc-seeded",
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


@pytest.mark.encsvc
def test_encoder_service_error_path_releases_slots():
    result = explore(
        pm.encoder_service_model(3, cap=3, max_inflight=2, fail_batch=True),
        max_schedules=N_SCHEDULES,
        name="encsvc-err",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


@pytest.mark.encsvc
def test_encoder_service_inflight_leak_bug_caught_and_replayable():
    result = explore(
        pm.encoder_service_model(3, cap=3, max_inflight=2, fail_batch=True,
                                 bug="leak_inflight"),
        max_schedules=400,
        name="encsvc-leak",
    )
    assert isinstance(result.failure, InvariantViolation)
    assert "in-flight slots leaked" in str(result.failure)
    with pytest.raises(InvariantViolation, match="in-flight slots leaked"):
        run_once(
            pm.encoder_service_model(3, cap=3, max_inflight=2, fail_batch=True,
                                     bug="leak_inflight"),
            choices=result.failing_schedule,
        )


@pytest.mark.encsvc
def test_encoder_service_drop_on_close_bug_caught_and_replayable():
    # shutdown racing admitted requests: the no-drain worker strands them
    result = sweep_seeds(
        pm.encoder_service_model(3, cap=3, max_inflight=1, bug="drop_on_close"),
        n_seeds=300,
        base_seed=31,
        name="encsvc-drop",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the shutdown-drop regression went undetected"
    )
    assert "dropped at shutdown" in str(result.failure)
    with pytest.raises(InvariantViolation, match="dropped at shutdown"):
        run_once(
            pm.encoder_service_model(3, cap=3, max_inflight=1, bug="drop_on_close"),
            seed=result.failing_seed,
        )


@pytest.mark.encsvc
def test_encoder_service_lost_close_wakeup_deadlocks():
    # a notify-less stop against the notify-driven idle wait = the lost-wakeup
    # class (the real service's timed tick is the defense); proven a deadlock
    result = explore(
        pm.encoder_service_model(2, cap=2, max_inflight=2,
                                 bug="lost_close_wakeup"),
        max_schedules=400,
        name="encsvc-lostwake",
    )
    assert isinstance(result.failure, DeadlockError), result.failure
    with pytest.raises(DeadlockError):
        run_once(
            pm.encoder_service_model(2, cap=2, max_inflight=2,
                                     bug="lost_close_wakeup"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# elastic membership change (quiesce -> handoff -> manifest -> install)
# ---------------------------------------------------------------------------


@pytest.mark.elastic
def test_membership_grow_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.membership_model(2, 3), max_schedules=N_SCHEDULES, name="member-grow"
    )
    _BATTERY_SECONDS["membership"] = time.monotonic() - t0
    assert result.ok, (
        f"membership invariant failed on schedule {result.failing_schedule}: "
        f"{result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.elastic
def test_membership_shrink_invariants_hold_exhaustive():
    result = explore(
        pm.membership_model(3, 2), max_schedules=N_SCHEDULES, name="member-shrink"
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.elastic
def test_membership_invariants_hold_seeded():
    result = sweep_seeds(
        pm.membership_model(2, 3), n_seeds=100, base_seed=41, name="member-seeded"
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


@pytest.mark.elastic
def test_membership_double_owner_bug_caught_and_replayable():
    # a donor that keeps serving handed-off slots: two owners at one epoch
    result = explore(
        pm.membership_model(2, 3, bug="double_owner"),
        max_schedules=300,
        name="member-double-owner",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the double-owner window went undetected"
    )
    assert (
        "owned by" in str(result.failure) or "duplicated" in str(result.failure)
    )
    with pytest.raises(InvariantViolation):
        run_once(
            pm.membership_model(2, 3, bug="double_owner"),
            choices=result.failing_schedule,
        )


@pytest.mark.elastic
def test_membership_orphan_range_bug_caught_and_replayable():
    # one moved key range's fragment never lands: no owner has its rows
    result = explore(
        pm.membership_model(2, 3, bug="orphan_range"),
        max_schedules=300,
        name="member-orphan",
    )
    assert isinstance(result.failure, InvariantViolation)
    assert "rows lost" in str(result.failure)
    with pytest.raises(InvariantViolation, match="rows lost"):
        run_once(
            pm.membership_model(2, 3, bug="orphan_range"),
            choices=result.failing_schedule,
        )


@pytest.mark.elastic
def test_membership_release_before_drain_bug_caught_with_seed():
    # a leaver tearing down before its handoff is durable loses its rows
    result = sweep_seeds(
        pm.membership_model(3, 2, bug="release_before_drain"),
        n_seeds=200,
        base_seed=51,
        name="member-early-release",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the leaver-released-before-drain regression went undetected"
    )
    assert "rows lost" in str(result.failure)
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation, match="rows lost"):
        run_once(
            pm.membership_model(3, 2, bug="release_before_drain"),
            seed=result.failing_seed,
        )


@pytest.mark.elastic
def test_membership_epoch_before_install_bug_caught_and_replayable():
    # the epoch bumps (and traffic resumes) before the ownership map
    # installs: rows route to ranks that no longer own the slot
    result = explore(
        pm.membership_model(2, 3, bug="epoch_before_install"),
        max_schedules=300,
        name="member-early-epoch",
    )
    assert isinstance(result.failure, InvariantViolation)
    assert "non-owner" in str(result.failure) or "released leavers" in str(
        result.failure
    )
    with pytest.raises(InvariantViolation):
        run_once(
            pm.membership_model(2, 3, bug="epoch_before_install"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# universal reshard: join-side state + chunked fragment streams ride the
# same membership transition (match bookkeeping, complete-or-abort chunks)
# ---------------------------------------------------------------------------


@pytest.mark.elastic
@pytest.mark.reshard
def test_membership_reshard_extension_invariants_hold_exhaustive():
    # the universal-reshard extension: join build/probe tokens, match
    # bookkeeping and chunked fragment streams all ride the transition — a
    # wider slot space forces multi-stream, multi-chunk interleavings
    t0 = time.monotonic()
    result = explore(
        pm.membership_model(2, 3, n_slots=8),
        max_schedules=N_SCHEDULES,
        name="member-reshard",
    )
    _BATTERY_SECONDS["reshard"] = time.monotonic() - t0
    assert result.ok, (
        f"reshard-extension invariant failed on schedule "
        f"{result.failing_schedule}: {result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.elastic
@pytest.mark.reshard
def test_membership_join_row_orphan_bug_caught_and_replayable():
    # one moved slot's probe-side join rows never make the fragment: the
    # arrangement re-keys under the new map with its probe side gone
    result = explore(
        pm.membership_model(2, 3, bug="join_row_orphan"),
        max_schedules=300,
        name="member-join-orphan",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the orphaned join-side rows went undetected"
    )
    assert "rows lost" in str(result.failure)
    assert "jright" in str(result.failure)
    with pytest.raises(InvariantViolation, match="rows lost"):
        run_once(
            pm.membership_model(2, 3, bug="join_row_orphan"),
            choices=result.failing_schedule,
        )


@pytest.mark.elastic
@pytest.mark.reshard
def test_membership_double_match_bug_caught_and_replayable():
    # match bookkeeping dropped from the fragments: the new owner re-emits
    # matches the donor already emitted pre-cut
    result = explore(
        pm.membership_model(2, 3, bug="double_match"),
        max_schedules=300,
        name="member-double-match",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the replayed join match went undetected"
    )
    assert "match emitted" in str(result.failure)
    with pytest.raises(InvariantViolation, match="match emitted"):
        run_once(
            pm.membership_model(2, 3, bug="double_match"),
            choices=result.failing_schedule,
        )


@pytest.mark.elastic
@pytest.mark.reshard
def test_membership_torn_chunk_install_bug_caught_with_seed():
    # a torn chunk stream (chunk durable, manifest never lands) imported by
    # an installer that skips the complete-or-abort check: rows vanish
    result = sweep_seeds(
        pm.membership_model(2, 3, bug="torn_chunk_install"),
        n_seeds=200,
        base_seed=61,
        name="member-torn-chunk",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the torn-chunk partial install went undetected"
    )
    assert "rows lost" in str(result.failure)
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation, match="rows lost"):
        run_once(
            pm.membership_model(2, 3, bug="torn_chunk_install"),
            seed=result.failing_seed,
        )


@pytest.mark.elastic
@pytest.mark.reshard
def test_membership_owner_map_stale_bug_caught_and_replayable():
    # a donor partitioning with a stale (prior-attempt) ownership map: rows
    # land on ranks the committed map does not own them to
    result = explore(
        pm.membership_model(2, 3, bug="owner_map_stale"),
        max_schedules=300,
        name="member-stale-map",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the stale-owner-map partition went undetected"
    )
    assert "reside on" in str(result.failure)
    with pytest.raises(InvariantViolation, match="reside on"):
        run_once(
            pm.membership_model(2, 3, bug="owner_map_stale"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# tiered IVF index (prefetch staging / background rebuild / generation swap)
# ---------------------------------------------------------------------------


@pytest.mark.tiered
def test_tiered_index_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.tiered_index_model(), max_schedules=N_SCHEDULES, name="tiered"
    )
    _BATTERY_SECONDS["tiered"] = time.monotonic() - t0
    assert result.ok, (
        f"tiered-index invariant failed on schedule {result.failing_schedule}: "
        f"{result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.tiered
def test_tiered_index_invariants_hold_seeded():
    result = sweep_seeds(
        pm.tiered_index_model(), n_seeds=100, base_seed=91, name="tiered-seeded"
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


@pytest.mark.tiered
def test_tiered_torn_swap_bug_caught_with_seed():
    # the reader must land between the two swap acquisitions — deep in the
    # tree, seeded walks reach it (same split as the membership batteries)
    result = sweep_seeds(
        pm.tiered_index_model(bug="torn_swap"),
        n_seeds=300,
        base_seed=7,
        name="tiered-torn",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the torn-swap regression went undetected"
    )
    assert "torn generation read" in str(result.failure)
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation, match="torn generation read"):
        run_once(
            pm.tiered_index_model(bug="torn_swap"), seed=result.failing_seed
        )


@pytest.mark.tiered
def test_tiered_incomplete_swap_bug_caught_and_replayable():
    result = explore(
        pm.tiered_index_model(bug="swap_incomplete"),
        max_schedules=300,
        name="tiered-incomplete",
    )
    assert isinstance(result.failure, InvariantViolation)
    assert "incomplete generation" in str(result.failure)
    with pytest.raises(InvariantViolation, match="incomplete generation"):
        run_once(
            pm.tiered_index_model(bug="swap_incomplete"),
            choices=result.failing_schedule,
        )


@pytest.mark.tiered
def test_tiered_drop_old_early_bug_caught_with_seed():
    # the old generation freed before the swap commits: an in-flight query
    # must hit the hole — again a deep interleaving, reached by seeded walks
    result = sweep_seeds(
        pm.tiered_index_model(bug="drop_old_early"),
        n_seeds=300,
        base_seed=7,
        name="tiered-dropold",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the old-generation-freed-early regression went undetected"
    )
    assert "incomplete generation" in str(result.failure)
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation, match="incomplete generation"):
        run_once(
            pm.tiered_index_model(bug="drop_old_early"), seed=result.failing_seed
        )


@pytest.mark.tiered
def test_tiered_stage_leak_bug_caught_and_replayable():
    result = explore(
        pm.tiered_index_model(bug="leak_stage"),
        max_schedules=400,
        name="tiered-leak",
    )
    assert isinstance(result.failure, InvariantViolation)
    assert "staging slots leaked" in str(result.failure)
    with pytest.raises(InvariantViolation, match="staging slots leaked"):
        run_once(
            pm.tiered_index_model(bug="leak_stage"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# quantized retrieval (scale recalibration install vs concurrent scoring)
# ---------------------------------------------------------------------------


@pytest.mark.quant
def test_quant_recalibration_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.quant_recalibration_model(), max_schedules=N_SCHEDULES, name="quant"
    )
    _BATTERY_SECONDS["quant"] = time.monotonic() - t0
    assert result.ok, (
        f"quant-recalibration invariant failed on schedule "
        f"{result.failing_schedule}: {result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.quant
def test_quant_recalibration_abort_holds_exhaustive():
    # the chaos `quant` op aborts before the install: every interleaving must
    # leave the old sidecars serving, bit-exact, with nothing published
    result = explore(
        pm.quant_recalibration_model(abort=True),
        max_schedules=N_SCHEDULES,
        name="quant-abort",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


@pytest.mark.quant
def test_quant_torn_install_bug_caught_with_seed():
    # the reader must land between the two install acquisitions — deep in
    # the tree, seeded walks reach it (same split as the tiered batteries)
    result = sweep_seeds(
        pm.quant_recalibration_model(bug="torn_install"),
        n_seeds=300,
        base_seed=7,
        name="quant-torn",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the torn sidecar-install regression went undetected"
    )
    assert "torn sidecar read" in str(result.failure)
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation, match="torn sidecar read"):
        run_once(
            pm.quant_recalibration_model(bug="torn_install"),
            seed=result.failing_seed,
        )


@pytest.mark.quant
def test_quant_stale_cast_bug_caught_and_replayable():
    result = explore(
        pm.quant_recalibration_model(bug="stale_cast"),
        max_schedules=400,
        name="quant-stale",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the stale-cached-cast regression went undetected"
    )
    assert "stale cached cast" in str(result.failure)
    with pytest.raises(InvariantViolation, match="stale cached cast"):
        run_once(
            pm.quant_recalibration_model(bug="stale_cast"),
            choices=result.failing_schedule,
        )


@pytest.mark.quant
def test_quant_install_after_abort_bug_caught_and_replayable():
    result = explore(
        pm.quant_recalibration_model(abort=True, bug="install_after_abort"),
        max_schedules=400,
        name="quant-abort-install",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the install-after-abort regression went undetected"
    )
    assert "published new scales" in str(result.failure)
    with pytest.raises(InvariantViolation, match="published new scales"):
        run_once(
            pm.quant_recalibration_model(abort=True, bug="install_after_abort"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# closed-loop autoscaler (controller <-> transition executor)
# ---------------------------------------------------------------------------


@pytest.mark.autoscale
def test_autoscaler_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.autoscaler_model(), max_schedules=N_SCHEDULES, name="autoscaler"
    )
    _BATTERY_SECONDS["autoscaler"] = time.monotonic() - t0
    assert result.ok, (
        f"autoscaler invariant failed on schedule {result.failing_schedule}: "
        f"{result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.autoscale
def test_autoscaler_invariants_hold_seeded():
    result = sweep_seeds(
        pm.autoscaler_model(), n_seeds=100, base_seed=61, name="autoscaler-seeded"
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


@pytest.mark.autoscale
def test_autoscaler_refusal_backoff_holds():
    # the preflight vote refuses the first scale-up: the controller must back
    # off typed and retry at most once per window, on every interleaving
    result = explore(
        pm.autoscaler_model(refuse_up=True),
        max_schedules=N_SCHEDULES,
        name="autoscaler-refuse",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


@pytest.mark.autoscale
def test_autoscaler_crash_racing_directive_holds():
    # a transition dying mid-flight hands the cluster to the recovery ladder;
    # the controller must never issue while it recovers, and never deadlock
    result = explore(
        pm.autoscaler_model(crash_up=True),
        max_schedules=N_SCHEDULES,
        name="autoscaler-crash",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


@pytest.mark.autoscale
def test_autoscaler_double_directive_bug_caught_and_replayable():
    result = explore(
        pm.autoscaler_model(bug="double_directive"),
        max_schedules=400,
        name="autoscaler-double",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the double-directive regression went undetected"
    )
    assert "two membership transitions in flight" in str(result.failure)
    with pytest.raises(InvariantViolation, match="two membership transitions"):
        run_once(
            pm.autoscaler_model(bug="double_directive"),
            choices=result.failing_schedule,
        )


@pytest.mark.autoscale
def test_autoscaler_cooldown_skip_bug_caught_with_seed():
    # the back-to-back issue needs the executor to complete BETWEEN two
    # controller ticks — deep in the decision tree, where seeded walks reach
    # faster than root-systematic DFS (same split as the membership
    # release-before-drain battery)
    result = sweep_seeds(
        pm.autoscaler_model(bug="cooldown_skip"),
        n_seeds=200,
        base_seed=71,
        name="autoscaler-cooldown",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the cooldown-skip regression went undetected"
    )
    assert "cooldown violated" in str(result.failure)
    assert result.failing_seed is not None
    # the SEED alone reproduces the storm (deterministic walk)
    with pytest.raises(InvariantViolation, match="cooldown violated"):
        run_once(
            pm.autoscaler_model(bug="cooldown_skip"), seed=result.failing_seed
        )


@pytest.mark.autoscale
def test_autoscaler_refusal_retry_storm_caught_with_seed():
    # the storm needs the refusal to land BETWEEN controller ticks before the
    # cooldown re-opens — deep in the tree, seeded walks reach it
    result = sweep_seeds(
        pm.autoscaler_model(refuse_up=True, bug="refusal_retry"),
        n_seeds=200,
        base_seed=81,
        name="autoscaler-retry-storm",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the refusal-retry storm went undetected"
    )
    assert "backoff window" in str(result.failure)
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation, match="backoff window"):
        run_once(
            pm.autoscaler_model(refuse_up=True, bug="refusal_retry"),
            seed=result.failing_seed,
        )


@pytest.mark.autoscale
def test_autoscaler_no_shed_first_bug_caught_and_replayable():
    result = explore(
        pm.autoscaler_model(bug="no_shed_first"),
        max_schedules=400,
        name="autoscaler-no-shed",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the shed-first ordering regression went undetected"
    )
    assert "shed-first" in str(result.failure)
    with pytest.raises(InvariantViolation, match="shed-first"):
        run_once(
            pm.autoscaler_model(bug="no_shed_first"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# read-replica follow / bounded-staleness serve
# ---------------------------------------------------------------------------


@pytest.mark.replicas
def test_replica_follow_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.replica_follow_model(), max_schedules=N_SCHEDULES, name="replica"
    )
    _BATTERY_SECONDS["replica"] = time.monotonic() - t0
    assert result.ok, (
        f"replica-follow invariant failed on schedule "
        f"{result.failing_schedule}: {result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.replicas
def test_replica_follow_invariants_hold_seeded():
    result = sweep_seeds(
        pm.replica_follow_model(), n_seeds=100, base_seed=29,
        name="replica-seeded",
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


@pytest.mark.replicas
def test_replica_torn_bootstrap_refuses_exhaustive():
    # a torn bootstrap is a typed refusal: out of rotation, zero serves,
    # every client query still reaches a terminal outcome (router failover)
    result = explore(
        pm.replica_follow_model(torn=True),
        max_schedules=N_SCHEDULES,
        name="replica-torn",
    )
    assert result.ok, f"{result.failing_schedule}: {result.failure}"


@pytest.mark.replicas
def test_replica_double_apply_bug_caught_with_seed():
    # the double apply needs BOTH pollers to list the same frame before
    # either applies it — deep in the tree, where seeded walks reach faster
    # than root-systematic DFS (same split as the membership and autoscaler
    # deep-race batteries); a small instance keeps the walk dense
    result = sweep_seeds(
        pm.replica_follow_model(2, 1, bug="double_apply"),
        n_seeds=300,
        base_seed=37,
        name="replica-double-apply",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the double-apply regression went undetected"
    )
    assert "applied twice" in str(result.failure)
    assert result.failing_seed is not None
    # the SEED alone reproduces the double apply (deterministic walk)
    with pytest.raises(InvariantViolation, match="applied twice"):
        run_once(
            pm.replica_follow_model(2, 1, bug="double_apply"),
            seed=result.failing_seed,
        )


@pytest.mark.replicas
def test_replica_stale_serve_bug_caught_with_seed():
    result = sweep_seeds(
        pm.replica_follow_model(bug="stale_serve"),
        n_seeds=300,
        base_seed=31,
        name="replica-stale-serve",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the stale-serve-past-bound regression went undetected"
    )
    assert "past the bound" in str(result.failure)
    assert result.failing_seed is not None
    # the SEED alone reproduces the stale serve (deterministic walk)
    with pytest.raises(InvariantViolation, match="past the bound"):
        run_once(
            pm.replica_follow_model(bug="stale_serve"),
            seed=result.failing_seed,
        )


@pytest.mark.replicas
def test_replica_torn_bootstrap_serve_bug_caught_and_replayable():
    result = explore(
        pm.replica_follow_model(torn=True, bug="torn_bootstrap_serve"),
        max_schedules=400,
        name="replica-torn-serve",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the torn-bootstrap-serve regression went undetected"
    )
    assert "half-installed" in str(result.failure)
    with pytest.raises(InvariantViolation, match="half-installed"):
        run_once(
            pm.replica_follow_model(torn=True, bug="torn_bootstrap_serve"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# trace ring: crash flush, epoch bump, cross-rank sampling consistency
# ---------------------------------------------------------------------------


@pytest.mark.trace
def test_trace_ring_invariants_hold_exhaustive():
    t0 = time.monotonic()
    result = explore(
        pm.trace_ring_model(), max_schedules=N_SCHEDULES, name="trace"
    )
    _BATTERY_SECONDS["trace"] = time.monotonic() - t0
    assert result.ok, (
        f"trace-ring invariant failed on schedule "
        f"{result.failing_schedule}: {result.failure}"
    )
    assert result.distinct_schedules >= N_SCHEDULES


@pytest.mark.trace
def test_trace_ring_invariants_hold_seeded():
    result = sweep_seeds(
        pm.trace_ring_model(), n_seeds=100, base_seed=43,
        name="trace-seeded",
    )
    assert result.ok, f"seed {result.failing_seed}: {result.failure}"
    assert result.distinct_schedules == 100


@pytest.mark.trace
def test_trace_orphan_on_bump_bug_caught_with_seed():
    # the orphan needs the bump to land inside a writer's start->verdict
    # window — deep in the tree, where seeded walks reach faster than
    # root-systematic DFS; the 1x1 instance keeps the walk dense
    result = sweep_seeds(
        pm.trace_ring_model(1, 1, bug="orphan_on_bump"),
        n_seeds=300,
        base_seed=41,
        name="trace-orphan",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the pending-swept-on-bump regression went undetected"
    )
    assert "orphaned" in str(result.failure)
    assert result.failing_seed is not None
    # the SEED alone reproduces the orphaned span (deterministic walk)
    with pytest.raises(InvariantViolation, match="orphaned"):
        run_once(
            pm.trace_ring_model(1, 1, bug="orphan_on_bump"),
            seed=result.failing_seed,
        )


@pytest.mark.trace
def test_trace_flush_deadlock_bug_caught_with_seed():
    # writer promotion holding the ring lock while wanting the file lock is
    # the AB/BA inversion with the crash flush's file-then-ring order — the
    # bug class the tracer's single re-entrant lock exists to prevent
    result = sweep_seeds(
        pm.trace_ring_model(1, 1, bug="flush_deadlock"),
        n_seeds=300,
        base_seed=47,
        name="trace-deadlock",
    )
    assert isinstance(result.failure, DeadlockError), (
        "the flush-on-crash lock inversion went undetected"
    )
    assert result.failing_seed is not None
    with pytest.raises(DeadlockError):
        run_once(
            pm.trace_ring_model(1, 1, bug="flush_deadlock"),
            seed=result.failing_seed,
        )


@pytest.mark.trace
def test_trace_split_sampling_bug_caught_and_replayable():
    result = explore(
        pm.trace_ring_model(bug="split_sampling"),
        max_schedules=400,
        name="trace-split",
    )
    assert isinstance(result.failure, InvariantViolation), (
        "the per-rank-coin sampling divergence went undetected"
    )
    assert "sampling split" in str(result.failure)
    with pytest.raises(InvariantViolation, match="sampling split"):
        run_once(
            pm.trace_ring_model(bug="split_sampling"),
            choices=result.failing_schedule,
        )


# ---------------------------------------------------------------------------
# lock order: the dynamic half of the reference's PWA101 bridge
# ---------------------------------------------------------------------------


def test_lock_order_inversion_deadlocks_and_the_fixed_order_is_clean():
    result = explore(
        pm.lock_order_model(inverted=True), max_schedules=200, name="inversion"
    )
    assert isinstance(result.failure, DeadlockError)
    with pytest.raises(DeadlockError):
        run_once(pm.lock_order_model(inverted=True), choices=result.failing_schedule)
    assert explore(pm.lock_order_model(inverted=False), max_schedules=200).ok


# ---------------------------------------------------------------------------
# parity with the reference's models
# ---------------------------------------------------------------------------

from pathway_tpu.internals import protocol_models as ref_pm  # noqa: E402
from pathway_tpu.internals import sched as ref_sched  # noqa: E402
from pathway_tpu_torch.internals import sched as port_sched  # noqa: E402

# (model, args, kwargs, search, bound, base seed): every model's correct
# variants under a DFS and a seeded sweep, and every planted bug under the
# search and bound the reference's suite finds it with
E, S = "explore", "sweep"
PARITY = {
    "fence": ("fence_rejoin_model", (2,), {}, E, 60, None),
    "fence-seeded": ("fence_rejoin_model", (2,), {}, S, 30, 1),
    "fence3": ("fence_rejoin_model", (3,), {}, E, 40, None),
    "fence-no-purge": ("fence_rejoin_model", (2,), {"bug": "no_purge"}, E, 400, None),
    "fence-deliver-stale": ("fence_rejoin_model", (2,), {"bug": "deliver_stale"}, E, 400, None),
    "ckpt": ("checkpoint_model", (3,), {}, E, 60, None),
    "ckpt-seeded": ("checkpoint_model", (3,), {}, S, 30, 5),
    "ckpt-crash": ("checkpoint_model", (3,), {"crash_rank": 1}, E, 60, None),
    "ckpt-toctou": ("checkpoint_model", (3,), {"bug": "toctou_commit"}, S, 300, 10),
    "ckpt-no-timeout": ("checkpoint_model", (3,), {"crash_rank": 1, "bug": "no_timeout"},
                        E, 400, None),
    "coal": ("coalescer_model", (3,), {"cap": 2}, E, 60, None),
    "coal-seeded": ("coalescer_model", (3,), {"cap": 2}, S, 30, 2),
    "coal-err": ("coalescer_model", (3,), {"cap": 2, "fail_batch": True}, E, 60, None),
    "coal-leak": ("coalescer_model", (3,), {"cap": 2, "fail_batch": True, "bug": "leak_slot"},
                  E, 300, None),
    "encsvc": ("encoder_service_model", (3,), {"cap": 2, "max_inflight": 2}, E, 60, None),
    "encsvc-seeded": ("encoder_service_model", (3,), {"cap": 2, "max_inflight": 2}, S, 30, 21),
    "encsvc-leak": ("encoder_service_model", (3,), {"cap": 3, "max_inflight": 2,
                    "fail_batch": True, "bug": "leak_inflight"}, E, 400, None),
    "encsvc-drop": ("encoder_service_model", (3,), {"cap": 3, "max_inflight": 1,
                    "bug": "drop_on_close"}, S, 300, 31),
    "encsvc-lostwake": ("encoder_service_model", (2,), {"cap": 2, "max_inflight": 2,
                        "bug": "lost_close_wakeup"}, E, 400, None),
    "member-grow": ("membership_model", (2, 3), {}, E, 60, None),
    "member-shrink": ("membership_model", (3, 2), {}, E, 60, None),
    "member-seeded": ("membership_model", (2, 3), {}, S, 30, 41),
    "member-reshard": ("membership_model", (2, 3), {"n_slots": 8}, E, 60, None),
    "member-double-owner": ("membership_model", (2, 3), {"bug": "double_owner"}, E, 300, None),
    "member-orphan": ("membership_model", (2, 3), {"bug": "orphan_range"}, E, 300, None),
    "member-early-release": ("membership_model", (3, 2), {"bug": "release_before_drain"},
                             S, 200, 51),
    "member-early-epoch": ("membership_model", (2, 3), {"bug": "epoch_before_install"},
                           E, 300, None),
    "member-join-orphan": ("membership_model", (2, 3), {"bug": "join_row_orphan"}, E, 300, None),
    "member-double-match": ("membership_model", (2, 3), {"bug": "double_match"}, E, 300, None),
    "member-torn-chunk": ("membership_model", (2, 3), {"bug": "torn_chunk_install"}, S, 200, 61),
    "member-stale-map": ("membership_model", (2, 3), {"bug": "owner_map_stale"}, E, 300, None),
    "tiered": ("tiered_index_model", (), {}, E, 60, None),
    "tiered-seeded": ("tiered_index_model", (), {}, S, 30, 91),
    "tiered-torn": ("tiered_index_model", (), {"bug": "torn_swap"}, S, 300, 7),
    "tiered-incomplete": ("tiered_index_model", (), {"bug": "swap_incomplete"}, E, 300, None),
    "tiered-dropold": ("tiered_index_model", (), {"bug": "drop_old_early"}, S, 300, 7),
    "tiered-leak": ("tiered_index_model", (), {"bug": "leak_stage"}, E, 400, None),
    "quant": ("quant_recalibration_model", (), {}, E, 60, None),
    "quant-abort": ("quant_recalibration_model", (), {"abort": True}, E, 60, None),
    "quant-seeded": ("quant_recalibration_model", (), {}, S, 30, 4),
    "quant-torn": ("quant_recalibration_model", (), {"bug": "torn_install"}, S, 300, 7),
    "quant-stale": ("quant_recalibration_model", (), {"bug": "stale_cast"}, E, 400, None),
    "quant-abort-install": ("quant_recalibration_model", (), {"abort": True,
                            "bug": "install_after_abort"}, E, 400, None),
    "autoscaler": ("autoscaler_model", (), {}, E, 60, None),
    "autoscaler-seeded": ("autoscaler_model", (), {}, S, 30, 61),
    "autoscaler-refuse": ("autoscaler_model", (), {"refuse_up": True}, E, 60, None),
    "autoscaler-crash": ("autoscaler_model", (), {"crash_up": True}, E, 60, None),
    "autoscaler-double": ("autoscaler_model", (), {"bug": "double_directive"}, E, 400, None),
    "autoscaler-cooldown": ("autoscaler_model", (), {"bug": "cooldown_skip"}, S, 200, 71),
    "autoscaler-retry-storm": ("autoscaler_model", (), {"refuse_up": True,
                               "bug": "refusal_retry"}, S, 200, 81),
    "autoscaler-no-shed": ("autoscaler_model", (), {"bug": "no_shed_first"}, E, 400, None),
    "replica": ("replica_follow_model", (), {}, E, 60, None),
    "replica-seeded": ("replica_follow_model", (), {}, S, 30, 29),
    "replica-torn": ("replica_follow_model", (), {"torn": True}, E, 60, None),
    "replica-double-apply": ("replica_follow_model", (2, 1), {"bug": "double_apply"},
                             S, 300, 37),
    "replica-stale-serve": ("replica_follow_model", (), {"bug": "stale_serve"}, S, 300, 31),
    "replica-torn-serve": ("replica_follow_model", (), {"torn": True,
                           "bug": "torn_bootstrap_serve"}, E, 400, None),
    "trace": ("trace_ring_model", (), {}, E, 60, None),
    "trace-seeded": ("trace_ring_model", (), {}, S, 30, 43),
    "trace-orphan": ("trace_ring_model", (1, 1), {"bug": "orphan_on_bump"}, S, 300, 41),
    "trace-deadlock": ("trace_ring_model", (1, 1), {"bug": "flush_deadlock"}, S, 300, 47),
    "trace-split": ("trace_ring_model", (), {"bug": "split_sampling"}, E, 400, None),
    "lock-order": ("lock_order_model", (), {"inverted": False}, E, 60, None),
    "lock-order-inverted": ("lock_order_model", (), {"inverted": True}, E, 200, None),
}


def _search(sched_mod, pm_mod, case: str):
    factory, args, kwargs, search, bound, base = PARITY[case]
    model = getattr(pm_mod, factory)(*args, **kwargs)
    if search == E:
        return sched_mod.explore(model, max_schedules=bound, name=case)
    return sched_mod.sweep_seeds(model, n_seeds=bound, base_seed=base, name=case)


def _verdict(result) -> tuple:
    failure = result.failure
    return (
        result.ok,
        None if failure is None else type(failure).__name__,
        None if failure is None else str(failure),
        result.schedules_run,
        result.distinct_schedules,
        result.failing_seed,
        result.failing_schedule,
    )


def test_parity_cases_cover_every_model_and_planted_bug():
    import inspect
    import re

    models = {n for n, f in vars(ref_pm).items()
              if n.endswith("_model") and inspect.isfunction(f)}
    assert models == {f for f, *_ in PARITY.values()}
    assert models == {n for n, f in vars(pm).items()
                      if n.endswith("_model") and inspect.isfunction(f)}
    bugs = set(re.findall(r'bug [!=]= "([a-z_]+)"', inspect.getsource(ref_pm)))
    assert bugs == {kw["bug"] for _f, _a, kw, *_ in PARITY.values() if "bug" in kw}


@pytest.mark.parametrize("case", list(PARITY))
def test_model_equals_the_reference_under_the_same_seeds_and_bounds(case):
    want = _verdict(_search(ref_sched, ref_pm, case))
    result = _search(port_sched, pm, case)
    assert _verdict(result) == want
    if result.failure is None:
        return
    # the failing schedule replays the same failure in the port, by its
    # choices, and by its seed where a sweep found it
    factory, args, kwargs, search, _bound, _base = PARITY[case]
    replays = [dict(choices=result.failing_schedule)]
    if search == S:
        replays.append(dict(seed=result.failing_seed))
    for how in replays:
        with pytest.raises(port_sched.SchedulingError) as exc_info:
            run_once(getattr(pm, factory)(*args, **kwargs), **how)
        assert type(exc_info.value) is type(result.failure)
        assert exc_info.value.schedule == result.failing_schedule


# ---------------------------------------------------------------------------
# budget guard: the whole protocol battery stays inside tier-1 bounds
# ---------------------------------------------------------------------------


def test_model_check_battery_within_budget():
    # the acceptance batteries above recorded their own wall time (no work is
    # redone here); each 200-schedule explore is a few seconds solo, and the
    # documented <60 s budget must hold even under full-suite load
    if set(_BATTERY_SECONDS) != {
        "fence", "ckpt", "encsvc", "membership", "reshard", "autoscaler",
        "tiered", "quant", "replica", "trace",
    }:
        pytest.skip("acceptance batteries did not run in this session (-k selection)")
    total = sum(_BATTERY_SECONDS.values())
    assert total < 60, f"model-check acceptance batteries too slow: {_BATTERY_SECONDS}"
