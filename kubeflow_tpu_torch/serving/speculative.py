"""Speculative decoding on the dense cache: a small draft model
proposes, the target verifies (counterpart:
kubeflow_tpu/serving/speculative.py).

Each round the draft proposes `gamma` tokens one decode step at a time
(single-token steps: the dense decode kernel on the card), the target
scores all gamma+1 positions in one forward, and the accept/reject rule
(accept d_i with probability min(1, p/q), tested as u·q < p) keeps the
target's sampling law exactly; greedy in = greedy out. A bonus token is
drawn from the target after a fully accepted window, else the residual
max(p - q, 0) is resampled at the first rejection. Partial acceptance
rolls back by moving both caches' cursors: cells past a cursor are
masked and overwritten by the next write, so nothing is copied.

Where the reference runs the rounds in a `lax.while_loop`, this is a
Python loop with one host sync per round (the accepted count k).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kubeflow_tpu_torch.serving.engine import (
    DecodeState,
    InferenceEngine,
    SamplingParams,
    sampling_dist,
)


class SpecStats(NamedTuple):
    emitted: int    # tokens produced (>= max_new)
    accepted: int   # drafted tokens accepted
    proposed: int   # drafted tokens proposed

    @property
    def acceptance_rate(self) -> float:
        return float(self.accepted) / max(float(self.proposed), 1.0)


def _draw(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """Sample [n] tokens from [n, vocab] probabilities; zero-probability
    tokens are never drawn, and a one-hot draws its token."""
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class SpeculativeEngine:
    """Wraps a (target, draft) engine pair. Batch 1 only: acceptance
    counts diverge across rows, and each cache keeps one cursor."""

    def __init__(self, target: InferenceEngine, draft: InferenceEngine):
        if getattr(target, "group", None) or getattr(draft, "group", None):
            raise ValueError("speculative decoding at tensor > 1 is not "
                             "ported yet (ROADMAP Queue 1 item 3g)")
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError(
                f"target vocab {target.cfg.vocab_size} != draft vocab "
                f"{draft.cfg.vocab_size}")
        self.target = target
        self.draft = draft

    @torch.inference_mode()
    def generate(self, prompt_tokens, *, max_new: int = 32, gamma: int = 4,
                 rng: torch.Generator | None = None, temperature=None,
                 top_k=None, top_p=None) -> tuple[torch.Tensor, SpecStats]:
        """-> ([1, max_new] int32 tokens on the target's device,
        SpecStats). Output follows the target's sampling law for the
        given knobs (the TARGET's EngineConfig supplies defaults; EOS is
        not special-cased — trim as with InferenceEngine.generate)."""
        target, draft = self.target, self.draft
        prompt = target._tensor(prompt_tokens, torch.int64)
        b, s = prompt.shape
        if b != 1:
            raise ValueError(f"speculative decoding is batch-1 (got {b})")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        # worst case one verify window extends gamma+1 past the cursor,
        # and the cursor can reach s + max_new - 1
        need = s + max_new + gamma
        for name, eng in (("target", target), ("draft", draft)):
            if need > eng.ec.max_len:
                raise ValueError(
                    f"prompt {s} + max_new {max_new} + gamma {gamma} "
                    f"exceeds {name} cache bucket {eng.ec.max_len}")
        sp, gen = target._resolve_sampling(temperature, top_k, top_p, rng,
                                           batch=1)
        dev = target.device

        tlogits, tstate = target._forward_cached(prompt, target.init_state(1))
        first = _draw(gen, sampling_dist(tlogits, sp))          # [1]
        _, dstate = draft._forward_cached(prompt, draft.init_state(1))
        out = [first]
        n, last, acc, prop = 1, first, 0, 0
        while n < max_new:
            # propose: gamma draft steps from the last emitted token
            drafted, qs = [], []
            tok = last
            for _ in range(gamma):
                logits, dstate = draft._forward_cached(tok[:, None], dstate)
                q = sampling_dist(logits, sp)                   # [1, vocab]
                tok = _draw(gen, q)
                drafted.append(tok)
                qs.append(q[0])
            drafted = torch.cat(drafted)                        # [gamma]
            qs = torch.stack(qs)                                # [gamma, V]

            # verify: one target pass over [last, d_1..d_gamma]
            tin = torch.cat([last, drafted])[None]
            all_logits, tstate = target._forward_cached(tin, tstate,
                                                        return_all=True)
            ps = sampling_dist(all_logits[0], sp)               # [gamma+1, V]

            # accept d_i with probability min(1, p(d_i) / q(d_i))
            us = torch.rand(gamma, generator=gen, device=dev)
            p_d = ps[:gamma].gather(-1, drafted[:, None])[:, 0]
            q_d = qs.gather(-1, drafted[:, None])[:, 0]
            accept = us * q_d < p_d   # u < p/q without the 0/0 hazard
            k = int(torch.cumprod(accept.int(), 0).sum())   # host sync

            # one extra token always lands: the bonus draw after a fully
            # accepted window, or the residual resample at the first
            # rejection (all-zero residual, p == q to rounding: p itself)
            if k == gamma:
                extra = _draw(gen, ps[gamma][None])
            else:
                diff = torch.clamp(ps[k] - qs[k], min=0.0)
                safe = torch.where(diff.sum() > 0, diff, ps[k])
                extra = _draw(gen, safe[None])
            out += [drafted[:k], extra]

            # roll back to the accepted prefix: the verify pass wrote
            # gamma+1 target cells (1+k valid), the draft gamma cells
            # (min(1+k, gamma) valid)
            tstate = DecodeState(tstate.k, tstate.v,
                                 tstate.length - gamma + k, tstate.pad,
                                 tstate.offset)
            dstate = DecodeState(dstate.k, dstate.v,
                                 dstate.length - gamma + min(1 + k, gamma),
                                 dstate.pad, dstate.offset)
            # a fully accepted window leaves the draft one token behind:
            # it never processed d_gamma. Feed it unconditionally; when
            # k < gamma the write lands past the rolled-back cursor and
            # is overwritten by the next round's first write
            _, dfed = draft._forward_cached(drafted[gamma - 1:][None],
                                            dstate)
            if k == gamma:
                dstate = dfed
            n += k + 1
            last = extra
            acc += k
            prop += gamma
        toks = torch.cat(out)[:max_new].to(torch.int32)[None]
        return toks, SpecStats(n, acc, prop)
