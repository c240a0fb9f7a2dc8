"""Elastic fault-tolerant trainer fleet: membership, resize, restart
(counterpart: kubeflow_tpu/train/elastic.py; the port imports nothing of
the JAX package).

The fleet registry's staleness machinery (fleet/registry.py) pointed at
TRAINER replicas: when a trainer dies mid-run, the survivors restart
from the last COMMITTED checkpoint at the new replica count and
training continues with identical global math.

Roles:
  * `ElasticCoordinator` — wraps a ReplicaRegistry; trainers register
    and heartbeat with (step, loss, phase); the coordinator decides the
    surviving world and stamps it with a monotonically increasing
    `generation`. Any membership change bumps the generation; losing a
    previously-live member also counts a restart. Exposes
    `train_replicas{state}`, `train_restarts_total`, `train_generation`
    and the goodput and straggler families on its registry, and the
    train SLOs' burn rates.
  * `create_coordinator_app` — the aiohttp surface (the reference's six
    `/elastic/*` routes with the same JSON, so its clients and control
    plane talk to this coordinator, plus `/metrics` and
    `/debug/traces`).
  * `run_worker` / `python -m kubeflow_tpu_torch.train.elastic worker` —
    a trainer replica: chief-only checkpoint writes, in-process
    restart-from-checkpoint when the generation moves, a goodput ledger
    (train/goodput.py) booking every second of its life.
  * `resize_state` — moves a live TrainState between two trainers'
    layouts without a disk round trip: gathered under the old one, cut
    under the new one.

Where the design differs from the reference. Its worker is "replicated
execution": one process computes the full global step on a mesh of
`world_size` virtual devices, whose data axis ZeRO partitions over. The
port has no virtual devices inside one process (a mesh forms its groups
over a process group, parallel/mesh.py). So each port worker computes
the full global step on its one device (`WorkerConfig.device`, the
card unless `--cpu`), as the reference's worker computes it on its
virtual mesh; its trainer carries the live world size as
`virtual_replicas`, which every checkpoint is stamped with, so a restart
at another size logs the resize exactly as the reference's does. The
sharded resize itself (a ZeRO-partitioned state saved at one data size
and restored at another) is the Checkpointer's, held by the gloo-gang
tests over train/fsdp.py's mesh trainer. The invariant is the
reference's: the global batch is a pure function of (seed, step)
(`_deterministic_batch`), so the loss at each step is the same at every
world size and across restarts.

Before a worker registers it initialises its device, so the heartbeat
thread never waits on the GIL through the CUDA context's creation; the
kernels' nvcc builds run as subprocesses (the GIL is free meanwhile).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable, Mapping

from kubeflow_tpu_torch import obs
from kubeflow_tpu_torch.fleet import registry as fleet_registry
from kubeflow_tpu_torch.fleet.registry import STATES, ReplicaRegistry
from kubeflow_tpu_torch.obs.metrics import Counter, Gauge, Registry
from kubeflow_tpu_torch.train.goodput import (
    GOODPUT_CAUSES,
    LOST_CAUSES,
    GoodputLedger,
    bind_ledger_metrics,
    checkpoint_histograms,
    goodput_metrics,
)

log = logging.getLogger(__name__)

LIVE_STATES = (fleet_registry.READY, fleet_registry.DEGRADED)

# Heartbeat phases a trainer replica reports. "saving" matters to the
# chaos harness: it is the window in which a SIGKILL lands mid-
# checkpoint-save.
PHASE_STEP = "step"
PHASE_SAVING = "saving"
PHASE_RESTORING = "restoring"
PHASE_DONE = "done"

# Everything a worker heartbeat may carry. The observatory keys
# (step_seconds, saves/save_seconds, goodput, metrics, trace) ride the
# same POST as the membership keys — one beat is both liveness and
# telemetry, so a worker that is alive is by construction observable.
HEARTBEAT_KEYS = ("step", "loss", "phase", "generation", "step_seconds",
                  "saves", "save_seconds", "goodput", "metrics", "trace")


class ElasticCoordinator:
    """Decides the surviving trainer world from heartbeats.

    Reuses ReplicaRegistry's staleness machinery verbatim; what it adds
    is trainer-shaped stats (float loss, monotonic step, phase — the
    registry's int-stat schema is serving-specific) and the generation/
    restart bookkeeping the workers key their restarts off.
    """

    def __init__(self, *, min_replicas: int = 1,
                 degraded_after_s: float = 6.0,
                 dead_after_s: float = 20.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None,
                 slo_step_time_s: float = 2.0,
                 slo_checkpoint_save_s: float = 10.0,
                 restart_burn_hold_s: float = 5.0,
                 slo_short_window_s: float = 60.0,
                 slo_long_window_s: float = 600.0):
        self.min_replicas = int(min_replicas)
        self._registry = ReplicaRegistry(
            degraded_after_s=degraded_after_s,
            dead_after_s=dead_after_s,
            clock=clock,
        )
        self._lock = threading.Lock()
        self._clock = clock
        self._stats: dict[str, dict[str, Any]] = {}
        self._members: tuple[str, ...] = ()
        self._generation = 0
        self.registry = registry if registry is not None \
            else obs.default_registry()
        self.replicas_gauge = self.registry.get("train_replicas")
        if self.replicas_gauge is None:
            self.replicas_gauge = Gauge(
                "train_replicas",
                "Trainer replicas by health state (heartbeat-driven; "
                "dead replicas shrink the next generation's world)",
                self.registry)
        self.generation_gauge = self.registry.get("train_generation")
        if self.generation_gauge is None:
            self.generation_gauge = Gauge(
                "train_generation",
                "Monotonic world generation; bumps on any trainer "
                "membership change", self.registry)
        self.restarts_total = self.registry.get("train_restarts_total")
        if self.restarts_total is None:
            self.restarts_total = Counter(
                "train_restarts_total",
                "Fleet-wide restart-from-checkpoint events (a "
                "previously-live trainer left the world)", self.registry)
        for s in STATES:
            self.replicas_gauge.set(0.0, state=s)
        self.generation_gauge.set(0.0)
        self.restarts_total.inc(0.0)
        # The full train_* metric catalog lives on the coordinator's
        # registry so one /metrics scrape sees every family zero-seeded
        # even before any checkpoint I/O or worker telemetry happened.
        checkpoint_histograms(self.registry)
        # -- goodput observatory --------------------------------------------
        # Worker labels pass a guard so a flapping fleet cannot mint
        # unbounded timeseries; past the cap stragglers collapse into
        # the "other" bucket (which we zero-seed so the family exists).
        self._worker_guard = obs.LabelGuard(max_values=32)
        self.worker_step_seconds = self.registry.get(
            "train_worker_step_seconds")
        if self.worker_step_seconds is None:
            self.worker_step_seconds = Gauge(
                "train_worker_step_seconds",
                "Latest steady-state step wall time per worker "
                "(straggler forensics; 0 = no step yet or worker lost)",
                self.registry)
        self.worker_step_seconds.set(0.0, worker=obs.OVERFLOW_LABEL)
        self.straggler_ratio = self.registry.get("train_straggler_ratio")
        if self.straggler_ratio is None:
            self.straggler_ratio = Gauge(
                "train_straggler_ratio",
                "Slowest / median live-worker step time (1.0 = uniform "
                "fleet; the gang runs at the slowest member's pace)",
                self.registry)
        self.straggler_ratio.set(0.0)
        self.goodput_fraction = self.registry.get("train_goodput_fraction")
        if self.goodput_fraction is None:
            self.goodput_fraction = Gauge(
                "train_goodput_fraction",
                "Fleet productive worker-seconds over all booked "
                "worker-seconds, cumulative across worker incarnations",
                self.registry)
        self.goodput_fraction.set(0.0)
        self.replay_seconds_total = self.registry.get(
            "train_replay_seconds_total")
        if self.replay_seconds_total is None:
            self.replay_seconds_total = Counter(
                "train_replay_seconds_total",
                "Fleet worker-seconds NOT spent advancing the run, by "
                "cause (replay = re-running steps past the last "
                "committed checkpoint — the direct price of a restart)",
                self.registry)
        for _c in LOST_CAUSES:
            self.replay_seconds_total.inc(0.0, cause=_c)
        # Zero-seed the worker-side goodput families too: one scrape of
        # the coordinator (or of /elastic/metrics with zero live
        # workers) still shows the full catalog shape.
        goodput_metrics(self.registry)
        # -- train SLOs (the engine renders slo_burn_rate) -----------------
        self.restart_burn_hold_s = float(restart_burn_hold_s)
        self._burn_until = 0.0
        self._saves_seen: dict[str, int] = {}
        self._goodput_last: dict[str, dict[str, float]] = {}
        self._fleet_seconds: dict[str, float] = {
            c: 0.0 for c in (*GOODPUT_CAUSES, obs.UNATTRIBUTED)}
        self.slo = obs.get_or_create_slo_engine(self.registry, [
            obs.Slo("train_step_time", 0.9,
                    threshold_s=float(slo_step_time_s),
                    description="90% of steady-state worker steps "
                                f"under {slo_step_time_s:g} s"),
            obs.Slo("train_checkpoint_save", 0.9,
                    threshold_s=float(slo_checkpoint_save_s),
                    description="90% of checkpoint saves under "
                                f"{slo_checkpoint_save_s:g} s"),
            obs.Slo("train_goodput", 0.9,
                    description="90% of goodput pulses productive: a "
                                "heartbeat interval must book at least "
                                "as many productive seconds as replay+"
                                "restore+compile+stall combined"),
            obs.Slo("train_restart_burn", 0.99,
                    description="99% of heartbeats outside a restart "
                                "hold window (a lost member burns the "
                                "budget for restart_burn_hold_s)"),
        ], short_window_s=slo_short_window_s,
           long_window_s=slo_long_window_s, clock=clock)

    # -- membership ------------------------------------------------------

    def register(self, replica_id: str, **stats) -> dict[str, Any]:
        with self._lock:
            self._registry.register(
                f"trainer://{replica_id}", replica_id=replica_id,
                models=("trainer",))
            self._stats.setdefault(replica_id, {})
            self._note(replica_id, stats)
            self._recompute()
            return self._world_locked()

    def heartbeat(self, replica_id: str, **stats) -> bool:
        """Refresh liveness + trainer stats. False for an unknown id —
        the worker must re-register (coordinator restarted)."""
        with self._lock:
            known = self._registry.heartbeat(replica_id)
            if known:
                self._note(replica_id, stats)
            self._recompute()
            return known

    def _note(self, replica_id: str, stats: Mapping[str, Any]) -> None:
        slot = self._stats.setdefault(replica_id, {})
        prev_step = slot.get("step")
        for key in HEARTBEAT_KEYS:
            if stats.get(key) is not None:
                slot[key] = stats[key]
        # straggler forensics: latest steady step wall per worker, and
        # one step-time SLO event per step ADVANCE (heartbeats repeat
        # the latest value between steps; re-recording it would drown
        # the burn windows in duplicates)
        ss = stats.get("step_seconds")
        if ss is not None:
            self.worker_step_seconds.set(
                float(ss), worker=self._worker_guard.admit(replica_id))
            if stats.get("step") is not None \
                    and stats.get("step") != prev_step:
                self.slo.observe("train_step_time", float(ss))
        # checkpoint-save SLO: once per completed save (the `saves`
        # counter dedups the repeated heartbeat snapshots)
        saves = stats.get("saves")
        if saves is not None and stats.get("save_seconds") is not None \
                and int(saves) > self._saves_seen.get(replica_id, 0):
            self._saves_seen[replica_id] = int(saves)
            self.slo.observe("train_checkpoint_save",
                             float(stats["save_seconds"]))
        gp = stats.get("goodput")
        if isinstance(gp, Mapping):
            self._ingest_goodput(replica_id, gp)
        # restart-burn pulse: every heartbeat inside the hold window
        # after a lost member is a bad event — the burn rate stays hot
        # for restart_burn_hold_s, then recovers
        self.slo.record("train_restart_burn",
                        self._clock() >= self._burn_until)

    def _ingest_goodput(self, replica_id: str,
                        gp: Mapping[str, Any]) -> None:
        """Fold one worker's cumulative ledger snapshot into the fleet
        cause totals via clamped deltas. A restarted worker's ledger
        begins at zero — detected by its wall clock rewinding — so
        every incarnation's seconds count exactly once."""
        secs = gp.get("seconds")
        if not isinstance(secs, Mapping):
            return
        wall = float(gp.get("wall_seconds") or 0.0)
        last = self._goodput_last.get(replica_id)
        if last is None or wall < last.get("_wall", 0.0) - 1e-6:
            last = {"_wall": 0.0}
        deltas: dict[str, float] = {}
        for c in (*GOODPUT_CAUSES, obs.UNATTRIBUTED):
            v = float(secs.get(c) or 0.0)
            deltas[c] = max(v - last.get(c, 0.0), 0.0)
            last[c] = max(v, last.get(c, 0.0))
        last["_wall"] = wall
        self._goodput_last[replica_id] = last
        for c, d in deltas.items():
            self._fleet_seconds[c] += d
            if d > 0 and c in LOST_CAUSES:
                self.replay_seconds_total.inc(d, cause=c)
        booked = sum(self._fleet_seconds.values())
        if booked > 0:
            self.goodput_fraction.set(
                self._fleet_seconds["productive"] / booked)
        # goodput pulse: this interval's productive seconds must cover
        # its hard overhead (replay/restore/compile/stall; save and
        # idle are normal operation and have their own signals)
        hard = (deltas["replay"] + deltas["checkpoint_restore"]
                + deltas["compile"] + deltas["stall"])
        if deltas["productive"] > 0 or hard > 0:
            self.slo.record("train_goodput",
                            deltas["productive"] >= hard)

    def sweep(self) -> None:
        with self._lock:
            self._recompute()

    def evict(self, replica_id: str | None = None) -> dict[str, Any]:
        """Evict one worker from the gang — the straggler actuator the
        fleet controller fires on `train_straggler_ratio` burn. With no
        `replica_id` the coordinator picks its own straggler: the live
        member with the slowest latest step. Eviction is just a
        deregister + recompute, so it rides the existing generation
        bump: survivors see the new generation on their next heartbeat
        and resize; the evicted worker's next heartbeat gets
        `known=False` and it rejoins as a fresh member (a slow HOST
        stays slow and gets evicted again; a transient straggler gets a
        second chance). Raises KeyError for an unknown id and
        RuntimeError when eviction would drop the gang below
        `min_replicas` — the controller books that as actuator_failed
        rather than stalling the whole job."""
        with self._lock:
            self._recompute()
            if len(self._members) <= self.min_replicas:
                raise RuntimeError(
                    f"eviction would drop the gang below min_replicas="
                    f"{self.min_replicas} (members: {len(self._members)})")
            if replica_id is None:
                slowest, slowest_ss = None, 0.0
                for rid in self._members:
                    ss = self._stats.get(rid, {}).get("step_seconds")
                    if ss is not None and float(ss) > slowest_ss:
                        slowest, slowest_ss = rid, float(ss)
                if slowest is None:
                    raise RuntimeError(
                        "no member has reported a step time yet — "
                        "nothing to call a straggler")
                replica_id = slowest
            elif replica_id not in self._members:
                raise KeyError(f"unknown member {replica_id!r}")
            self._registry.deregister(replica_id)
            self._recompute()
            log.warning("trainer eviction: %s removed (generation %d)",
                        replica_id, self._generation)
            world = self._world_locked()
            world["evicted"] = replica_id
            return world

    def _recompute(self) -> None:
        self._registry.sweep()
        live = tuple(sorted(
            rep.id for rep in self._registry.replicas()
            if rep.state in LIVE_STATES))
        if live != self._members:
            lost = set(self._members) - set(live)
            self._generation += 1
            if lost:
                self.restarts_total.inc()
                # open the restart-burn window: heartbeats record bad
                # until it closes, so slo_burn_rate{slo=
                # train_restart_burn} spikes for the hold duration
                self._burn_until = self._clock() + self.restart_burn_hold_s
                self.slo.record("train_restart_burn", False)
                for rid in lost:
                    self.worker_step_seconds.set(
                        0.0, worker=self._worker_guard.admit(rid))
                log.warning(
                    "trainer world change: lost %s, generation %d -> "
                    "world %s (survivors restart from last committed "
                    "checkpoint)", sorted(lost), self._generation, live)
            else:
                log.info("trainer world grew to %s (generation %d)",
                         live, self._generation)
            self._members = live
        for state, n in self._registry.counts().items():
            self.replicas_gauge.set(float(n), state=state)
        self.generation_gauge.set(float(self._generation))
        # straggler ratio over the LIVE members that have stepped:
        # slowest / median latest step time (1.0 = uniform; a worker
        # with no steps yet simply isn't in the sample)
        vals = []
        for rid in self._members:
            ss = self._stats.get(rid, {}).get("step_seconds")
            if ss is not None and float(ss) > 0:
                vals.append(float(ss))
        if vals:
            med = obs.sample_quantile(vals, 0.5)
            self.straggler_ratio.set(
                max(vals) / med if med and med > 0 else 0.0)
        else:
            self.straggler_ratio.set(0.0)

    # -- world view ------------------------------------------------------

    def _world_locked(self, include_stats: bool = False) -> dict[str, Any]:
        world: dict[str, Any] = {
            "generation": self._generation,
            "members": list(self._members),
            "world_size": len(self._members),
            "min_replicas": self.min_replicas,
            "ready": len(self._members) >= self.min_replicas,
            "chief": self._members[0] if self._members else None,
            # per-member progress rides on every response: workers use
            # it for soft lockstep (never run ahead of the slowest live
            # member by more than a couple of steps)
            "steps": {
                rid: self._stats.get(rid, {}).get("step")
                for rid in self._members
            },
            "phases": {
                rid: self._stats.get(rid, {}).get("phase")
                for rid in self._members
            },
            "step_seconds": {
                rid: self._stats.get(rid, {}).get("step_seconds")
                for rid in self._members
            },
            # fleet cause totals accumulate across worker incarnations
            # AND deaths — the goodput summary survives the workers
            # (the chaos harness reads it after an arm's fleet exits)
            "goodput": {
                "seconds": dict(self._fleet_seconds),
                "fraction": (
                    self._fleet_seconds["productive"]
                    / sum(self._fleet_seconds.values())
                    if sum(self._fleet_seconds.values()) > 0 else 0.0),
            },
        }
        if include_stats:
            world["replicas"] = {
                rid: {k: v for k, v in self._stats.get(rid, {}).items()
                      if k not in ("metrics", "trace")}
                for rid in self._members
            }
        return world

    def world(self, include_stats: bool = False) -> dict[str, Any]:
        with self._lock:
            self._recompute()
            return self._world_locked(include_stats)

    # -- observatory surfaces ---------------------------------------------

    def federated_metrics(self) -> str:
        """One exposition for the whole fleet: the coordinator's own
        registry plus every LIVE member's latest heartbeat exposition,
        merged by obs.federate (counters/gauges sum; histograms merge
        on the union bucket grid; a member with no exposition yet shows
        up as `fleet_federation_up{replica} 0`)."""
        with self._lock:
            self._recompute()
            scrapes: dict[str, str | None] = {
                "coordinator": self.registry.render()}
            for rid in self._members:
                scrapes[rid] = self._stats.get(rid, {}).get("metrics")
        return obs.federate(scrapes)

    def merged_traces(self) -> dict[str, Any]:
        """Every live worker's Chrome trace as its own process track
        (obs.merge_chrome_traces names the tracks by replica id)."""
        with self._lock:
            self._recompute()
            segments = []
            for rid in self._members:
                payload = self._stats.get(rid, {}).get("trace")
                if isinstance(payload, dict):
                    segments.append((rid, payload))
        return obs.merge_chrome_traces(segments)


def create_coordinator_app(coord: ElasticCoordinator):
    """The aiohttp surface workers and the chaos harness talk to: the
    reference's six routes and JSON, plus `/metrics` and
    `/debug/traces`."""
    from aiohttp import web

    from kubeflow_tpu_torch.obs import endpoints as obs_endpoints

    app = web.Application()

    async def register(request):
        body = await request.json()
        world = coord.register(
            str(body["replica_id"]),
            **{k: body.get(k) for k in HEARTBEAT_KEYS})
        return web.json_response(world)

    async def heartbeat(request):
        body = await request.json()
        known = coord.heartbeat(
            str(body["replica_id"]),
            **{k: body.get(k) for k in HEARTBEAT_KEYS})
        world = coord.world()
        world["known"] = known
        return web.json_response(world)

    async def world(request):
        return web.json_response(coord.world(include_stats=True))

    async def evict(request):
        try:
            body = await request.json()
        except Exception:
            body = {}
        rid = body.get("replica_id") if isinstance(body, dict) else None
        try:
            world = coord.evict(str(rid) if rid is not None else None)
        except KeyError as e:
            return web.json_response({"error": str(e)}, status=404)
        except RuntimeError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response(world)

    async def metrics_federated(request):
        return web.Response(text=coord.federated_metrics(),
                            content_type="text/plain")

    async def traces_merged(request):
        return web.json_response(coord.merged_traces())

    app.router.add_post("/elastic/register", register)
    app.router.add_post("/elastic/heartbeat", heartbeat)
    app.router.add_post("/elastic/evict", evict)
    app.router.add_get("/elastic/world", world)
    app.router.add_get("/elastic/metrics", metrics_federated)
    app.router.add_get("/elastic/traces", traces_merged)
    obs_endpoints.mount_observability(
        app, registry=coord.registry, tracer=obs.DEFAULT_TRACER)
    return app


# -- live cross-layout resize ------------------------------------------


def resize_state(state, to_trainer, *, from_trainer=None):
    """Re-partition a TrainState onto `to_trainer`'s layout (another
    mesh over the same process group, or one device) without a
    checkpoint round trip: every leaf and moment is gathered whole under
    `from_trainer`'s layout (None: `state` is one device's, whole
    already), then cut under the new trainer's. On a mesh every rank
    calls it (the gathers are collectives)."""
    if from_trainer is None:
        params, opt_state = state.params, state.opt_state
    else:
        params = from_trainer.gather_params(state)
        opt_state = from_trainer.gather_opt_state(state)

    def whole(t):
        # a leaf that no gather cuts comes back as the live tensor, and
        # a one-device target would share it with `state`
        return t.detach().clone()

    params = _tree_map(whole, params)
    opt_state = {"count": int(opt_state["count"]),
                 **{slot: [whole(t) for t in opt_state[slot]]
                    for slot in to_trainer.optimizer.slots}}
    return to_trainer.state_from(params, opt_state, int(state.step))


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# -- worker --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    coordinator_url: str
    replica_id: str
    ckpt_dir: str
    total_steps: int = 16
    save_every: int = 4
    # 12 divides by every world size up to 4 (and 6): the reference's
    # global batch shards over its data axis at every size the world may
    # shrink or grow to
    batch: int = 12
    seq: int = 16
    seed: int = 0
    heartbeat_s: float = 0.05
    # Chaos knob: sleep this long after dispatching a checkpoint save,
    # BEFORE the COMMITTED marker can be written — widens the window in
    # which a SIGKILL leaves an uncommitted step dir on disk.
    slow_save_s: float = 0.0
    loss_log: str = ""
    join_timeout_s: float = 60.0
    # Continuous-deployment hook: when set, the CHIEF publishes every
    # COMMITTED checkpoint to this fleet router's `POST /fleet/versions`
    # (version "step-<N>", source pointing at ckpt_dir). Best-effort: a
    # down router never blocks a save.
    publish_url: str = ""
    publish_model: str = "llama-tiny"
    # where the worker trains: the card unless asked for the CPU
    device: str = "cuda:0"


class _CoordinatorClient:
    """Tiny sync JSON client (urllib; workers have no aiohttp loop)."""

    def __init__(self, base_url: str):
        self.base = base_url.rstrip("/")

    def _post(self, path: str, body: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read().decode())

    def register(self, replica_id: str, **stats) -> dict:
        return self._post("/elastic/register",
                          {"replica_id": replica_id, **stats})

    def heartbeat(self, replica_id: str, **stats) -> dict:
        return self._post("/elastic/heartbeat",
                          {"replica_id": replica_id, **stats})


def _publish_version(wc: WorkerConfig, ckpt, published: set) -> bool:
    """Publish the newest COMMITTED checkpoint to the fleet router's
    version registry. Async saves commit on the NEXT save/close, so
    "newest committed" at publish time can trail the save just
    dispatched — the close() call site catches the final one. Idempotent
    via `published` (steps already announced); best-effort: a network
    failure is logged and swallowed, the training loop never stalls on
    a down router."""
    step = ckpt.latest_committed_step()
    if step is None or step in published:
        return False
    path = ckpt.latest_committed_path()
    body = {
        "version": f"step-{step}",
        "model": wc.publish_model,
        "step": step,
        "source": {"checkpoint": wc.ckpt_dir, "step": step,
                   "path": str(path)},
    }
    import urllib.request

    req = urllib.request.Request(
        wc.publish_url.rstrip("/") + "/fleet/versions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            ok = resp.status == 200
    except OSError as e:
        log.warning("publish of step %d to %s failed: %s", step,
                    wc.publish_url, e)
        return False
    if ok:
        published.add(step)
        log.info("published committed step %d (%s) to %s", step,
                 body["version"], wc.publish_url)
    return ok


def _deterministic_batch(cfg_vocab: int, batch: int, seq: int, seed: int,
                         step: int):
    """The data stream is a pure function of (seed, step) so every
    replica — and every post-restart incarnation at any world size —
    sees the IDENTICAL global batch (the reference's numbers, numpy's
    generator): loss-curve parity across resizes is then a hard
    assertion."""
    import numpy as np

    rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
    toks = rng.integers(0, cfg_vocab, (batch, seq))
    tgts = rng.integers(0, cfg_vocab, (batch, seq))
    return toks, tgts


def _build_trainer(world_size: int, cfg, *, registry=None, tracer=None,
                   device="cuda:0"):
    """The worker's trainer: llama under `cfg` on `device`, dense CE
    (`llama.apply`), the reference's TrainConfig(warmup_steps=2,
    total_steps=1000), stamped with `world_size` replicas."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    if world_size < 1:
        raise ValueError(f"world size {world_size} < 1")
    return Trainer(
        apply_fn=lambda p, t: llama.apply(p, cfg, t),
        init_fn=lambda seed: llama.init(cfg, seed, device, train=True),
        train_config=TrainConfig(warmup_steps=2, total_steps=1000),
        device=device,
        registry=registry,
        tracer=tracer,
        virtual_replicas=world_size,
    )


class _Heartbeater(threading.Thread):
    """Off-thread heartbeat loop: the training thread blocks for seconds
    inside a fresh trainer's first step and a restore, which must NOT
    read as death to the coordinator. The thread posts the latest
    (step, loss, phase) snapshot every `interval` and keeps the
    freshest world view for the training loop to poll locally."""

    def __init__(self, client: _CoordinatorClient, replica_id: str,
                 interval: float, world: dict[str, Any]):
        super().__init__(daemon=True, name=f"heartbeat-{replica_id}")
        self.client = client
        self.replica_id = replica_id
        self.interval = interval
        self.status: dict[str, Any] = {"phase": PHASE_RESTORING}
        self.world = world
        self._stop = threading.Event()
        # optional per-beat payload producer: run_worker wires the
        # goodput ledger / registry exposition / trace through this so
        # telemetry stays fresh while the training thread is blocked
        self.enrich: Callable[[], dict[str, Any]] | None = None

    def update(self, **status) -> None:
        self.status = {**self.status, **status}

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            snap = dict(self.status)
            if self.enrich is not None:
                try:
                    snap.update(self.enrich())
                except Exception as e:  # noqa: BLE001 — keep beating
                    log.debug("heartbeat enrich failed: %s", e)
            try:
                w = self.client.heartbeat(self.replica_id, **snap)
                if not w.get("known"):
                    w = self.client.register(self.replica_id, **snap)
                self.world = w
            except Exception as e:  # noqa: BLE001 — transient; keep beating
                log.debug("heartbeat failed: %s", e)
            self._stop.wait(self.interval)


def run_worker(wc: WorkerConfig) -> dict[str, Any]:
    """A trainer replica under the elastic coordinator: computes the
    full global step on `wc.device` with its trainer stamped at the live
    world size (the module docstring); the chief (lowest live id) alone
    writes checkpoints; every generation bump triggers
    restart-from-last-committed at the new world size."""
    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig, Checkpointer,
    )

    device = resolve_device(wc.device)
    # the device's context before the heartbeat thread starts
    torch.empty(0, device=device)
    cfg = llama.LLAMA_TINY
    client = _CoordinatorClient(wc.coordinator_url)
    loss_f = open(wc.loss_log, "a", buffering=1) if wc.loss_log else None

    # Worker-local observatory: a private registry and tracer (shipped
    # to the coordinator on every heartbeat and federated at
    # /elastic/metrics) and the goodput ledger that books every second
    # of this incarnation's life into an exclusive cause.
    wreg = Registry()
    tracer = obs.Tracer()
    ledger = GoodputLedger()
    bind_ledger_metrics(wreg, ledger)

    def log_loss(step: int, loss: float, generation: int) -> None:
        if loss_f is not None:
            loss_f.write(json.dumps({
                "replica": wc.replica_id, "step": step, "loss": loss,
                "generation": generation}) + "\n")

    world = client.register(wc.replica_id, phase=PHASE_RESTORING)
    hb = _Heartbeater(client, wc.replica_id, wc.heartbeat_s, world)

    def _enrich() -> dict[str, Any]:
        # evaluated by the heartbeat THREAD each beat, so the numbers
        # keep moving while the training thread is inside a first step
        # or a restore
        payload = tracer.chrome_trace()
        payload["traceEvents"] = (list(payload["traceEvents"])
                                  + ledger.counter_events(prefix="train"))
        return {"goodput": ledger.snapshot(), "metrics": wreg.render(),
                "trace": payload}

    hb.enrich = _enrich
    hb.start()
    deadline = time.monotonic() + wc.join_timeout_s
    while not hb.world.get("ready"):
        if time.monotonic() > deadline:
            hb.stop()
            raise TimeoutError(
                f"world never reached min_replicas="
                f"{hb.world.get('min_replicas')}: {hb.world}")
        time.sleep(wc.heartbeat_s)
    world = hb.world

    generation = world["generation"]
    restores = 0
    corrupt_restores = 0
    saves = 0
    published_steps: set = set()  # committed steps announced to the fleet
    trainer = ckpt = state = None
    last_loss = float("nan")
    last_saved = -1

    def rebuild(world_size: int):
        nonlocal trainer, ckpt, state, restores, last_saved
        last_saved = -1
        if ckpt is not None:
            ckpt.close()
        with ledger.book("compile"):
            trainer = _build_trainer(world_size, cfg, registry=wreg,
                                     tracer=tracer, device=device)
        ckpt = Checkpointer(
            CheckpointConfig(
                wc.ckpt_dir, save_interval_steps=wc.save_every,
                enable_async=True, install_crash_handlers=True),
            trainer,
            run_metadata={"replica": wc.replica_id},
            registry=wreg,
        )
        with ledger.book("checkpoint_restore"):
            state = ckpt.restore_or_init(wc.seed)
        # any step at or below the pre-crash high-water mark is now a
        # re-run: the ledger books it to `replay`, not `productive`
        ledger.note_restore(int(state.step))
        restores += 1

    try:
        rebuild(world["world_size"])
    except Exception:
        corrupt_restores += 1
        hb.stop()
        raise
    log.info("worker %s joined generation %d at world %d, step %d",
             wc.replica_id, generation, world["world_size"],
             int(state.step))

    def others_behind(world, my_step: int, lag: int = 2) -> bool:
        """Soft lockstep: don't run more than `lag` steps ahead of the
        slowest LIVE member (a restoring survivor re-winds to the last
        committed step; the gang waits for it as a collective would)."""
        steps = [s for rid, s in world.get("steps", {}).items()
                 if rid != wc.replica_id and s is not None]
        return bool(steps) and min(steps) < my_step - lag

    while True:
        step = int(state.step)
        if step >= wc.total_steps:
            break
        hb.update(step=step, loss=last_loss, phase=PHASE_STEP,
                  generation=generation)
        world = hb.world
        if world["generation"] == generation and \
                others_behind(world, step):
            with ledger.book("stall"):
                time.sleep(wc.heartbeat_s)
            continue
        # `ready` gated only initial formation: a world that shrank
        # BELOW min_replicas still continues (that is the point of
        # elasticity) as long as anyone is left.
        if world["generation"] != generation and world["world_size"] >= 1:
            generation = world["generation"]
            log.warning(
                "worker %s: generation %d, world -> %s; restarting "
                "from last committed checkpoint at %d replicas",
                wc.replica_id, generation, world["members"],
                world["world_size"])
            hb.update(phase=PHASE_RESTORING, generation=generation)
            try:
                rebuild(world["world_size"])
            except Exception:
                corrupt_restores += 1
                hb.stop()
                raise
            continue
        toks, tgts = _deterministic_batch(
            cfg.vocab_size, wc.batch, wc.seq, wc.seed, step)
        # a fresh trainer's first step (kernel builds and loads,
        # allocator growth) is booked to `compile`
        compiling = not trainer._stepped
        t_step = time.perf_counter()
        state, loss = trainer.step(
            state, torch.as_tensor(toks, dtype=torch.int32),
            torch.as_tensor(tgts, dtype=torch.int32))
        # float() waits for the step's work, so dt is the step's wall,
        # not just its dispatch
        last_loss = float(loss)
        new_step = int(state.step)
        dt_step = time.perf_counter() - t_step
        ledger.note_step(step, dt_step, tokens=wc.batch * wc.seq,
                         flops=trainer.step_flops(wc.batch, wc.seq),
                         compiling=compiling)
        step = new_step
        log_loss(step, last_loss, generation)
        if not compiling:
            # steady-state step wall feeds straggler forensics and the
            # train_step_time SLO; first-step walls would drown them
            hb.update(step=step, loss=last_loss, step_seconds=dt_step,
                      generation=generation)
        chief = world.get("chief") == wc.replica_id
        if chief and step % wc.save_every == 0 and step != last_saved:
            hb.update(step=step, loss=last_loss, phase=PHASE_SAVING,
                      generation=generation)
            with ledger.book("checkpoint_save"):
                t_save = time.perf_counter()
                ckpt.save(state, force=True)
                dt_save = time.perf_counter() - t_save
                last_saved = step
                saves += 1
                hb.update(saves=saves, save_seconds=dt_save)
                if wc.publish_url:
                    # announce whatever is COMMITTED by now (async saves
                    # trail by one flush — close() below publishes the
                    # final step)
                    _publish_version(wc, ckpt, published_steps)
                if wc.slow_save_s > 0:
                    # Chaos window: the save is dispatched but its
                    # COMMITTED marker cannot appear until the next
                    # save/wait — a SIGKILL in here is a mid-save
                    # crash. The sleep books to checkpoint_save: it
                    # widens exactly the window a slow real save would.
                    time.sleep(wc.slow_save_s)
            hb.update(phase=PHASE_STEP)

    final_step = int(state.step)
    hb.update(step=final_step, loss=last_loss, phase=PHASE_DONE,
              generation=generation)
    world = hb.world
    if world.get("chief") == wc.replica_id and final_step != last_saved:
        with ledger.book("checkpoint_save"):
            ckpt.save(state, force=True)
    with ledger.book("checkpoint_save"):
        ckpt.close()  # drains async saves + writes COMMITTED markers
    if world.get("chief") == wc.replica_id and wc.publish_url:
        # the final save is durable now: publish it
        _publish_version(wc, ckpt, published_steps)
    # Drain barrier: keep heartbeating until every live member reports
    # done — vanishing the moment WE finish would read as a death to a
    # straggler (soft lockstep keeps the skew to a couple of steps, so
    # this is brief).
    drain_deadline = time.monotonic() + wc.join_timeout_s
    while time.monotonic() < drain_deadline:
        world = hb.world
        steps = world.get("steps", {})
        if all(s is not None and s >= wc.total_steps
               for s in steps.values()):
            break
        time.sleep(wc.heartbeat_s)
    hb.stop()
    result = {
        "replica": wc.replica_id,
        "final_step": final_step,
        "final_loss": last_loss,
        "generation": generation,
        "restores": restores,
        "corrupt_restores": corrupt_restores,
        "world_size": world["world_size"],
        "published": len(published_steps),
        # per-incarnation goodput book: a harness reads these RESULT
        # lines after the processes are gone
        "goodput": ledger.snapshot(),
    }
    if loss_f is not None:
        loss_f.close()
    return result


# -- CLI -----------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="elastic trainer fleet: coordinator / worker roles")
    parser.add_argument("role", choices=("coordinator", "worker"))
    parser.add_argument("--port", type=int, default=0,
                        help="coordinator listen port")
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--degraded-after-s", type=float, default=1.0)
    parser.add_argument("--dead-after-s", type=float, default=2.0)
    parser.add_argument("--coordinator", default="",
                        help="worker: coordinator base URL")
    parser.add_argument("--replica-id", default="trainer-0")
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--save-every", type=int, default=4)
    parser.add_argument("--batch", type=int, default=12)
    parser.add_argument("--seq", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--slow-save-s", type=float, default=0.0)
    parser.add_argument("--loss-log", default="")
    parser.add_argument("--publish-url", default="",
                        help="fleet router base URL: the chief "
                             "publishes each COMMITTED checkpoint to "
                             "POST /fleet/versions")
    parser.add_argument("--publish-model", default="llama-tiny",
                        help="served model name the published "
                             "versions target")
    parser.add_argument("--cpu", action="store_true",
                        help="worker: train on the CPU (default: the "
                             "CUDA card, cuda:0)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.role == "coordinator":
        from aiohttp import web

        coord = ElasticCoordinator(
            min_replicas=args.min_replicas,
            degraded_after_s=args.degraded_after_s,
            dead_after_s=args.dead_after_s,
        )
        web.run_app(create_coordinator_app(coord), port=args.port,
                    print=None)
        return 0
    if not args.coordinator or not args.ckpt_dir:
        parser.error("worker needs --coordinator and --ckpt-dir")
    result = run_worker(WorkerConfig(
        coordinator_url=args.coordinator,
        replica_id=args.replica_id,
        ckpt_dir=args.ckpt_dir,
        total_steps=args.steps,
        save_every=args.save_every,
        batch=args.batch,
        seq=args.seq,
        seed=args.seed,
        slow_save_s=args.slow_save_s,
        loss_log=args.loss_log,
        publish_url=args.publish_url,
        publish_model=args.publish_model,
        device="cpu" if args.cpu else "cuda:0",
    ))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
