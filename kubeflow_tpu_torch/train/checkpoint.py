"""Checkpoint / resume of a `Trainer`'s state, in the port's own format
(counterpart: kubeflow_tpu/train/checkpoint.py).

The reference writes orbax, which needs JAX; the port keeps the
reference's names and semantics over files PyTorch reads back with
`torch.load(weights_only=True)`. Layout per step:

    <dir>/<step>/params.pt          flat name -> tensor ("blocks.wq", ...)
    <dir>/<step>/opt_state.pt       {"count": n, slot: {name: t}} for
                                     each optimizer slot (AdamW: "mu",
                                     "nu"; Adafactor: "v_row", "v_col",
                                     "v", an empty tensor where a leaf
                                     has no such slot), over the trained
                                     leaves only (a frozen base: none)
    <dir>/<step>/run_metadata.json  the run config, for provenance
    <dir>/<step>/data_state.json    the data stream's position
    <dir>/<step>/COMMITTED          written once the step is durable

Params are a file of their own, so serving (`load_serving_params`)
reads them and never the moments (2x the params' bytes). Each file is
written under a temporary name, flushed to disk, then renamed; the
COMMITTED marker is written only after every file of the step is
durable. Restore resolves "latest" through the markers, so a step
directory left behind by a crash mid-save is skipped with a log line
and removed before a re-save of its step.

`enable_async=True`: the device-to-host copy runs on the caller's
thread (the next optimizer step updates the tensors in place, so the
copy must be taken before it), the disk write on a background thread,
and the commit happens on `wait()` or the next save, as the reference's
`_flush_commits` does.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import logging
import os
import shutil
import signal
import threading
import time
from typing import Any, Mapping

import torch

from kubeflow_tpu_torch.obs.metrics import (
    default_registry,
    get_or_create_histogram,
)
from kubeflow_tpu_torch.train.trainer import Trainer, TrainState

PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"
META_FILE = "run_metadata.json"
DATA_FILE = "data_state.json"
COMMIT_MARKER = "COMMITTED"
TOKENIZER_FILE = "tokenizer.json"

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    save_interval_steps: int = 1000
    max_to_keep: int | None = 3
    # async saves overlap the disk write with the next train steps;
    # close()/wait() must run before the process exits
    enable_async: bool = True
    # a trained tokenizer carried with the checkpoint: copied once to
    # <directory>/tokenizer.json, where the serving CLI's
    # `--tokenizer auto` looks
    tokenizer_path: str = ""
    # register SIGTERM + atexit handlers that finish the pending save
    # (wait + close) before the process dies. Off by default: building
    # an object should not change the process's signal disposition
    install_crash_handlers: bool = False


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    """Nested dict of tensors -> flat "a.b" -> tensor, in insertion
    order (the order of the trainer's leaves)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _write_durable(path: str, write) -> None:
    """`write(tmp_path)`, then fsync and rename onto `path`."""
    tmp = path + ".tmp"
    write(tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(state: TrainState, optimizer) -> tuple[dict, dict]:
    """Host copies of a state's params and optimizer slots, by flat
    name (the slots' over the leaves `optimizer` trains)."""
    names = [n for n, _ in optimizer.trained(state.params)]

    def host(t):
        return t.detach().to("cpu", copy=True)

    params = {n: host(t) for n, t in flatten(state.params).items()}
    opt = {"count": int(state.opt_state["count"]),
           **{slot: {n: host(t) for n, t in
                     zip(names, state.opt_state[slot], strict=True)}
              for slot in optimizer.slots}}
    return params, opt


def _load(path: str, device) -> Any:
    return torch.load(path, map_location=device, weights_only=True)


class Checkpointer:
    """Save/restore a Trainer's TrainState.

    Usage:
        ckpt = Checkpointer(CheckpointConfig(dir), trainer)
        state = ckpt.restore_or_init(seed)
        for ...:
            state, loss = trainer.step(state, ...)
            ckpt.maybe_save(state)
        ckpt.close()
    """

    def __init__(self, config: CheckpointConfig, trainer: Trainer,
                 run_metadata: Mapping[str, Any] | None = None,
                 registry=None):
        self.config = config
        self.trainer = trainer
        self.run_metadata = dict(run_metadata or {})
        os.makedirs(config.directory, exist_ok=True)
        self._pending: tuple[int, threading.Thread, list] | None = None
        self._closed = False
        self._handlers_installed = False
        reg = registry if registry is not None else default_registry()
        # the reference's names and help for these two families
        self.save_seconds = get_or_create_histogram(
            reg, "train_checkpoint_save_seconds",
            "checkpoint save wall time (async: dispatch + previous-save "
            "drain, not the device->disk copy itself)")
        self.restore_seconds = get_or_create_histogram(
            reg, "train_checkpoint_restore_seconds",
            "checkpoint restore wall time onto the current mesh "
            "(includes cross-replica-count resharding on resize)")
        self.save_seconds.seed()
        self.restore_seconds.seed()
        if config.install_crash_handlers:
            self.install_crash_handlers()

    @property
    def virtual_replicas(self) -> int:
        """The data-axis size a checkpoint is stamped with: one device,
        no data axis."""
        return 1

    # -- save ------------------------------------------------------------

    def _should_save(self, step: int) -> bool:
        """The reference's orbax policy: a step past the latest saved
        one, on the save interval."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.config.save_interval_steps == 0

    def save(self, state: TrainState, *, force: bool = False,
             data_state: Mapping[str, Any] | None = None) -> bool:
        """Save `state` at its step when the interval says so (or
        `force`). `data_state` rides along as JSON: pass the data
        stream's position so a resumed run continues the same stream.
        -> whether a save was started."""
        step = int(state.step)
        t0 = time.perf_counter()
        # the previous async save's commit may land only once its write
        # is durable
        self._flush_commits()
        step_dir = self.step_path(step)
        if os.path.exists(step_dir):
            if self._is_committed(step):
                log.info("step %d already committed under %s — "
                         "skipping save", step, self.config.directory)
                return False
            log.warning(
                "removing stale uncommitted dir for step %d under %s "
                "before re-save", step, self.config.directory)
            shutil.rmtree(step_dir)
        if not force and not self._should_save(step):
            return False
        meta = dict(self.run_metadata)
        meta["virtual_replicas"] = self.virtual_replicas
        params, opt = _to_host(state, self.trainer.optimizer)
        os.makedirs(step_dir)
        if self.config.enable_async:
            errors: list = []

            def run():
                try:
                    self._write(step_dir, params, opt, meta, data_state)
                except BaseException as e:  # noqa: BLE001 — re-raised on wait
                    errors.append(e)

            thread = threading.Thread(target=run, name=f"ckpt-{step}",
                                      daemon=True)
            thread.start()
            self._pending = (step, thread, errors)
        else:
            self._write(step_dir, params, opt, meta, data_state)
            self._commit(step)
        if self.config.tokenizer_path:
            self._carry_tokenizer()
        self.save_seconds.observe(time.perf_counter() - t0)
        return True

    @staticmethod
    def _write(step_dir: str, params: dict, opt: dict, meta: dict,
               data_state) -> None:
        _write_durable(os.path.join(step_dir, PARAMS_FILE),
                       lambda p: torch.save(params, p))
        _write_durable(os.path.join(step_dir, OPT_FILE),
                       lambda p: torch.save(opt, p))
        for name, obj in ((META_FILE, meta),
                          (DATA_FILE, dict(data_state or {}))):
            def write(p, obj=obj):
                with open(p, "w") as f:
                    json.dump(obj, f)
            _write_durable(os.path.join(step_dir, name), write)
        _fsync_dir(step_dir)

    def _commit(self, step: int) -> None:
        step_dir = self.step_path(step)
        if not os.path.isdir(step_dir):
            return

        def write(p):
            with open(p, "w") as f:
                f.write(f"{step}\n")

        _write_durable(os.path.join(step_dir, COMMIT_MARKER), write)
        _fsync_dir(step_dir)
        self._prune()

    def _prune(self) -> None:
        """Keep the newest `max_to_keep` committed steps."""
        keep = self.config.max_to_keep
        if keep is None:
            return
        steps = self.committed_steps()
        for step in steps[:max(0, len(steps) - keep)]:
            shutil.rmtree(self.step_path(step), ignore_errors=True)

    def _flush_commits(self) -> None:
        """Wait for the pending async write and commit its step; a write
        that failed raises here and leaves its step uncommitted."""
        if self._pending is None:
            return
        step, thread, errors = self._pending
        thread.join()
        self._pending = None
        if errors:
            raise errors[0]
        self._commit(step)

    def _carry_tokenizer(self) -> None:
        """Copy the configured tokenizer to <dir>/tokenizer.json once."""
        dst = os.path.join(self.config.directory, TOKENIZER_FILE)
        if not os.path.exists(dst):
            _write_durable(dst, lambda p: shutil.copyfile(
                self.config.tokenizer_path, p))

    def maybe_save(self, state: TrainState, *,
                   data_state: Mapping[str, Any] | None = None) -> bool:
        """Save iff the save interval says so."""
        return self.save(state, force=False, data_state=data_state)

    # -- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Every step directory on disk, committed or not, ascending."""
        if not os.path.isdir(self.config.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.config.directory)
                      if d.isdigit() and os.path.isdir(self.step_path(d)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        if self._pending is not None:
            steps = sorted(set(steps) | {self._pending[0]})
        return steps[-1] if steps else None

    def step_path(self, step) -> str:
        """The directory one step's checkpoint lives in."""
        return os.path.join(self.config.directory, str(step))

    def _is_committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.step_path(step),
                                           COMMIT_MARKER))

    def committed_steps(self) -> list[int]:
        """Steps with a COMMITTED marker, ascending; steps a crash left
        half written are logged and left out."""
        out = []
        for step in self.all_steps():
            if self._is_committed(step):
                out.append(step)
            elif self._pending is None or self._pending[0] != step:
                log.warning(
                    "checkpoint step %d under %s has no %s marker "
                    "(crash mid-save?) — skipping uncommitted step",
                    step, self.config.directory, COMMIT_MARKER)
        return out

    def latest_committed_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *,
                device=None) -> TrainState:
        """Restore onto `device` (default: the trainer's). `step=None`
        takes the newest committed step and falls back to the next older
        one when it fails to load; an explicit `step` is restored
        exactly or raises."""
        self._flush_commits()
        if step is not None:
            candidates = [step]
        else:
            candidates = list(reversed(self.committed_steps()))
            if not candidates and self.latest_step() is not None:
                raise FileNotFoundError(
                    f"checkpoints exist under {self.config.directory} "
                    "but none carry a COMMITTED marker — all were "
                    "interrupted mid-save")
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint under {self.config.directory}")
        device = self.trainer.device if device is None else device
        t0 = time.perf_counter()
        for i, cand in enumerate(candidates):
            try:
                state = self._load_state(cand, device)
            except Exception as e:  # noqa: BLE001 — fall back, then re-raise
                if step is not None or i + 1 >= len(candidates):
                    raise
                log.warning(
                    "committed checkpoint step %d failed to restore "
                    "(%s) — falling back to step %d",
                    cand, e, candidates[i + 1])
                continue
            self.restore_seconds.observe(time.perf_counter() - t0)
            return state
        raise AssertionError("unreachable")

    def _load_state(self, step: int, device) -> TrainState:
        step_dir = self.step_path(step)
        flat = _load(os.path.join(step_dir, PARAMS_FILE), device)
        opt = _load(os.path.join(step_dir, OPT_FILE), device)
        params = unflatten(flat)
        optimizer = self.trainer.optimizer
        names = [n for n, _ in optimizer.trained(params)]
        if any(set(opt.get(slot, ())) != set(names)
               for slot in optimizer.slots):
            raise ValueError(
                f"step {step}: optimizer state and trained params name "
                "different leaves (or another optimizer wrote it)")
        opt_state = {"count": int(opt["count"]),
                     **{slot: [opt[slot][n] for n in names]
                        for slot in optimizer.slots}}
        return self.trainer.state_from(params, opt_state, step,
                                       device=device)

    def _read_json(self, name: str, step: int | None, *,
                   missing_ok: bool) -> dict[str, Any]:
        """One JSON item of `step` (default: the latest). `missing_ok`
        absorbs only an ABSENT item (a checkpoint written before it
        existed); a present but unreadable one raises, since restoring
        {} would e.g. restart a resumed data stream from its start."""
        self._flush_commits()
        if step is None:
            step = self.latest_step()
        if step is None:
            return {}
        path = os.path.join(self.step_path(step), name)
        if missing_ok and not os.path.exists(path):
            return {}
        with open(path) as f:
            return dict(json.load(f) or {})

    def restore_metadata(self, step: int | None = None) -> dict[str, Any]:
        return self._read_json(META_FILE, step, missing_ok=False)

    def restore_data_state(self, step: int | None = None) -> dict[str, Any]:
        """The data stream's position saved beside `step` ({} when the
        checkpoint has none)."""
        return self._read_json(DATA_FILE, step, missing_ok=True)

    def restore_or_init(self, seed: int) -> TrainState:
        """The resume entry point: the latest committed checkpoint if
        there is one, else a fresh init (a directory holding only
        interrupted saves logs and initializes)."""
        self._flush_commits()
        if self.latest_committed_step() is not None:
            return self.restore()
        if self.latest_step() is not None:
            log.warning(
                "no committed checkpoint under %s (only interrupted "
                "saves) — initializing fresh state",
                self.config.directory)
        return self.trainer.init(seed)

    # -- lifecycle -------------------------------------------------------

    def wait(self) -> None:
        self._flush_commits()

    def close(self) -> None:
        if self._closed:
            return
        self._flush_commits()
        self._closed = True

    def install_crash_handlers(self) -> None:
        """Finish the pending save on SIGTERM and at interpreter exit,
        chaining any prior SIGTERM disposition. Idempotent. A SIGKILL
        bypasses this: that is what the COMMITTED markers are for."""
        if self._handlers_installed:
            return
        self._handlers_installed = True
        atexit.register(self._drain_quietly)
        prev = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            self._drain_quietly()
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            # not the main thread: atexit alone still drains
            log.debug("SIGTERM handler not installed (non-main thread)")

    def _drain_quietly(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 — dying anyway
            log.exception("checkpoint drain on shutdown failed")


def latest_committed_dir(directory: str) -> str:
    """The newest committed step directory under a checkpoint
    directory; raises when there is none."""
    steps = sorted(int(d) for d in (os.listdir(directory)
                                    if os.path.isdir(directory) else ())
                   if d.isdigit()
                   and os.path.exists(os.path.join(directory, d,
                                                   COMMIT_MARKER)))
    if not steps:
        raise FileNotFoundError(
            f"no committed checkpoint under {directory}")
    return os.path.join(directory, str(steps[-1]))


def serving_params(params: Mapping[str, Any], cfg, device) -> dict:
    """A trained param tree -> the serving storage of `cfg`'s model
    (block matrices in cfg.dtype, every other leaf fp32; the rule of
    `llama.leaf_dtype`, which gemma shares), on `device`."""
    from kubeflow_tpu_torch.models.llama import leaf_dtype

    def conv(name, t):
        return t.detach().to(device=device, dtype=leaf_dtype(cfg, name))

    out = {k: conv(k, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: conv(k, v) for k, v in params["blocks"].items()}
    return out


def load_serving_params(directory: str, cfg, device,
                        step: int | None = None) -> dict:
    """The params of committed `step` (None: the newest committed step)
    under `directory`, in serving storage on `device`. Reads params.pt
    only: the optimizer's moments never leave the disk."""
    if step is None:
        step_dir = latest_committed_dir(directory)
    else:
        step_dir = os.path.join(directory, str(step))
        if not os.path.exists(os.path.join(step_dir, COMMIT_MARKER)):
            raise FileNotFoundError(
                f"no committed step {step} under {directory}")
    flat = _load(os.path.join(step_dir, PARAMS_FILE), device)
    return serving_params(unflatten(flat), cfg, device)
