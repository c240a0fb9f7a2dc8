"""Single-device training (counterpart: kubeflow_tpu/train/trainer.py).

The reference jits a sharded step over a device mesh; the port runs one
card, eagerly: the loss and its gradients through autograd (the model's
attention through the flash kernels' `autograd.Function`), then an AdamW
update written out to match optax's, in place. There is no mesh, so no
sharding rules; the reference's obs bridge (spans, histograms,
PhaseProfiler, CompileWatch) and checkpoints are ROADMAP work.

optax parity, where PyTorch's defaults differ:
- the learning-rate schedule is evaluated at the update count before it
  increments, so `warmup_cosine_decay_schedule(init_value=0)` gives
  lr 0 on the first update while the moments still update;
- `clip_by_global_norm` scales by max_norm / norm only when norm >=
  max_norm (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6);
- adamw decays every leaf, norms included, with eps 1e-8 and no
  eps_root.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.device import resolve_device

Params = dict


def estimate_step_flops(n_params: int, tokens: int) -> float:
    """Model FLOPs for one train step: the standard 6·N·T estimate
    (2·N·T forward + 4·N·T backward). MODEL flops, the numerator of MFU:
    attention's quadratic terms and rematerialisation are left out."""
    return 6.0 * float(n_params) * float(tokens)


def _masked_mean(nll: torch.Tensor,
                 mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_loss(logits: torch.Tensor,   # [b, s, vocab] fp32
                       targets: torch.Tensor,  # [b, s] int
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy over valid positions."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def _ce_chunk(hidden, head_c, targets, m, acc, gold, off):
    """One vocab chunk of the online (max, sumexp, gold-logit) stats."""
    chunk = head_c.shape[1]
    logits_c = hidden @ head_c.float()                 # [b, s, chunk]
    new_m = torch.maximum(m, logits_c.max(dim=-1).values)
    acc = (acc * torch.exp(m - new_m)
           + torch.exp(logits_c - new_m[..., None]).sum(dim=-1))
    local = targets - off
    in_chunk = (local >= 0) & (local < chunk)
    picked = torch.gather(logits_c, -1,
                          local.clamp(0, chunk - 1).long()[..., None])[..., 0]
    return new_m, acc, gold + torch.where(in_chunk, picked, 0.0)


def chunked_cross_entropy_from_hidden(
    hidden: torch.Tensor,   # [b, s, D] final (normed) hidden states
    head: torch.Tensor,     # [D, vocab] unembedding matrix
    targets: torch.Tensor,  # [b, s] int
    mask: torch.Tensor | None = None,
    *,
    num_chunks: int = 8,
) -> torch.Tensor:
    """CE without materialising the full [b, s, vocab] fp32 logits: a
    loop over vocab chunks keeps the online (max, sumexp, gold-logit)
    stats, and each chunk body runs under `torch.utils.checkpoint`, so
    the backward recomputes the chunk's logits instead of storing them.
    Matches `cross_entropy_loss(hidden @ head, ...)` to fp32 rounding."""
    b, s, _ = hidden.shape
    vocab = head.shape[1]
    # Largest divisor of vocab <= requested: never silently degrade to
    # one full-vocab chunk (that would materialise exactly the logits
    # this function exists to avoid).
    requested = num_chunks
    num_chunks = max(1, min(num_chunks, vocab))
    while vocab % num_chunks:
        num_chunks -= 1
    if num_chunks == 1 and requested > 1 and vocab > 4096:
        logging.getLogger(__name__).warning(
            "chunked CE running UNCHUNKED: vocab %d shares no divisor "
            "<= the requested chunk count %d — full [b, s, vocab] "
            "logits will materialize", vocab, requested)
    chunk = vocab // num_chunks
    hidden = hidden.float()
    dev = hidden.device
    m = torch.full((b, s), -math.inf, device=dev)
    acc = torch.zeros(b, s, device=dev)
    gold = torch.zeros(b, s, device=dev)
    # split once: its backward concatenates the chunks' head gradients
    # once, where slicing per chunk would write a full-size one per chunk
    for i, head_c in enumerate(head.split(chunk, dim=1)):
        m, acc, gold = checkpoint(_ce_chunk, hidden, head_c, targets, m,
                                  acc, gold, i * chunk, use_reentrant=False)
    return _masked_mean((m + torch.log(acc)) - gold, mask)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # Gradient accumulation: split each step's batch into this many
    # microbatches and average their grads (mask-weighted, fp32
    # accumulator) before ONE optimizer update. 1 = off.
    grad_accum: int = 1
    # "adamw" only; the reference's "adafactor" is ROADMAP work.
    optimizer: str = "adamw"
    # ZeRO-style partitioning of the optimizer state over the data axis.
    # On one device there is no data axis, so this is an exact no-op, as
    # it is in the reference on data=1 meshes; kept for config parity.
    zero_optimizer: bool = True


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps=1e-8, weight_decay)) over a nested dict of tensors, updated
    in place. State: fp32 moments mirroring the params and one update
    count."""

    eps = 1e-8

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=tc.learning_rate,
            warmup_steps=tc.warmup_steps,
            decay_steps=max(tc.total_steps, tc.warmup_steps + 1),
            end_value=tc.learning_rate * 0.1)

    def init(self, params: Params) -> dict:
        leaves = _leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads: list, opt_state: dict, params: Params) -> None:
        """Apply one update to `params` and `opt_state` in place; `grads`
        are in the order of `_leaves(params)`."""
        tc = self.tc
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        # optax: where(norm < max, g, g / norm * max)
        clip = torch.where(norm < tc.grad_clip, torch.ones_like(norm),
                           tc.grad_clip / norm)
        count = opt_state["count"]
        lr = self.schedule(count)
        count += 1
        bc1 = 1 - tc.b1**count
        bc2 = 1 - tc.b2**count
        for p, g, mu, nu in zip(_leaves(params), grads, opt_state["mu"],
                                opt_state["nu"]):
            g = g * clip
            mu.mul_(tc.b1).add_(g, alpha=1 - tc.b1)
            nu.mul_(tc.b2).addcmul_(g, g, value=1 - tc.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            u.add_(p, alpha=tc.weight_decay)
            p.add_(u, alpha=-lr)
        opt_state["count"] = count


def make_optimizer(tc: TrainConfig, freeze_labels: Params | None = None
                   ) -> AdamW:
    """AdamW with warmup-cosine, as the reference's optax chain."""
    if freeze_labels is not None:
        raise NotImplementedError(
            "freeze_labels (LoRA / frozen subtrees) is not ported yet "
            "(ROADMAP Queue 1)")
    if tc.optimizer == "adafactor":
        raise NotImplementedError(
            "optimizer 'adafactor' is not ported yet (ROADMAP Queue 1); "
            "use 'adamw'")
    if tc.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {tc.optimizer!r} "
                         "(adamw | adafactor)")
    return AdamW(tc)


def _leaves(params: Params) -> list:
    """Leaves of a nested dict, in insertion order."""
    out = []
    for v in params.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


class TrainState:
    """Params, optimizer state and step count. `Trainer.step` updates it
    in place (the reference returns a new, donated one) and returns it."""

    def __init__(self, params, opt_state, step):
        self.params = params
        self.opt_state = opt_state
        self.step = step


class Trainer:
    """Init and step functions for a model on one device.

    `apply_fn(params, tokens) -> logits`; `init_fn(seed) -> params`
    (moved to `device`, which defaults to the CUDA card). `loss_fn(params,
    tokens, targets, mask) -> scalar` overrides the default apply_fn →
    cross-entropy pipeline, e.g. `chunked_cross_entropy_from_hidden`
    over `llama.hidden`."""

    def __init__(self, apply_fn: Callable, init_fn: Callable[[int], Params],
                 train_config: TrainConfig = TrainConfig(),
                 loss_fn: Callable | None = None,
                 device: torch.device | str | None = None):
        self.apply_fn = apply_fn
        self.init_fn = init_fn
        self.tc = train_config
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(train_config)
        self._n_params: int | None = None
        self._opt_bytes: int | None = None

    def _loss(self, params, tokens, targets, mask):
        if self.loss_fn is not None:
            return self.loss_fn(params, tokens, targets, mask)
        return cross_entropy_loss(self.apply_fn(params, tokens), targets,
                                  mask)

    def init(self, seed: int) -> TrainState:
        return self.init_from_params(self.init_fn(seed))

    def init_from_params(self, params: Params) -> TrainState:
        """Fresh optimizer state around existing params (fine-tuning).
        The params are moved to the device and become autograd leaves;
        tensors already there are used as they are, not copied."""
        def prep(tree):
            return {k: prep(v) if isinstance(v, dict)
                    else v.detach().to(self.device).requires_grad_(True)
                    for k, v in tree.items()}

        params = prep(params)
        opt_state = self.optimizer.init(params)
        self._n_params = sum(p.numel() for p in _leaves(params))
        self._opt_bytes = sum(t.numel() * t.element_size()
                              for t in opt_state["mu"] + opt_state["nu"])
        return TrainState(params, opt_state, 0)

    def _value_and_grad(self, params, tokens, targets, mask):
        leaves = _leaves(params)
        loss = self._loss(params, tokens, targets, mask)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def step(self, state: TrainState, tokens, targets, mask=None):
        """One optimizer step on a [b, s] batch -> (state, loss)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        targets = torch.as_tensor(targets, device=self.device)
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        acc = self.tc.grad_accum
        if acc > 1 and tokens.shape[0] % acc:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"grad_accum {acc}")
        if acc <= 1:
            loss, grads = self._value_and_grad(state.params, tokens,
                                               targets, mask)
        else:
            # Each micro loss is a masked MEAN, so grads and losses are
            # re-weighted by the micro's mask mass: the full-batch step up
            # to summation order.
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in _leaves(state.params)]
            lsum = torch.zeros((), device=self.device)
            wsum = torch.zeros((), device=self.device)
            for toks, tgts, m in zip(tokens.chunk(acc), targets.chunk(acc),
                                     mask.chunk(acc)):
                l_, g_ = self._value_and_grad(state.params, toks, tgts, m)
                w = m.float().sum()
                for a, g in zip(gsum, g_):
                    a.add_(g.float() * w)
                lsum = lsum + l_.float() * w
                wsum = wsum + w
            denom = torch.clamp(wsum, min=1.0)
            grads = [(g / denom).to(p.dtype)
                     for g, p in zip(gsum, _leaves(state.params))]
            loss = lsum / denom
        self.optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, loss

    @property
    def param_count(self) -> int:
        """Total trainable parameter count (the N in 6·N·T); known once
        a state was built."""
        if self._n_params is None:
            raise RuntimeError("param_count is known after init() or "
                               "init_from_params()")
        return self._n_params

    def step_flops(self, batch: int, seq: int) -> float:
        """Model FLOPs one `step()` spends on a [batch, seq] block."""
        return estimate_step_flops(self.param_count, batch * seq)

    def opt_state_bytes(self) -> int:
        """Optimizer-state bytes (both moments; known once a state was
        built), all of it on the one device."""
        if self._opt_bytes is None:
            raise RuntimeError("opt_state_bytes is known after init() or "
                               "init_from_params()")
        return self._opt_bytes
