"""LoRA: low-rank adapters, for training with a frozen base and for
serving adapter packs (counterpart: kubeflow_tpu/train/lora.py).

`LoraConfig` (rank, alpha, targets, the reference's checks),
`_TARGET_DIMS` (each adaptable block weight's in and out widths, as
attributes of the model config: llama and gemma share the schema) and
`merge_lora`, which folds adapters into the block weights: training's
forward, and the oracle the tests and the card's smoke run hold the
unmerged serving path to. Adapter trees keep the reference's layout,
`{"blocks": {name: {"A": [L, d_in, r], "B": [L, r, d_out]}}}`.

Training, as the reference trains: the train tree is `{"base": params,
"lora": adapters}` (`lora_train_tree`), `lora_freeze_labels` gives the
trainer's `freeze_labels` (the base: no gradient, no update, no
optimizer state), and `lora_loss_fn` merges the detached base with the
adapters each step before the model's loss, so autograd reaches only A
and B. `init_lora` draws A from a fan-in-scaled truncated normal and
sets B = 0, so step 0 is the base. `lora_logical_axes` gives the
train tree's adapters their sharding on the trainer's mesh. Under
tensor parallelism the merge runs on the rank's blocks: B is cut with
the base weight's output axis (wq, wk, wv), A with its input axis (wo),
the other factor held whole, its gradient summed over the axis by the
trainer (train/fsdp.py); a KV weight held whole keeps both whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubeflow_tpu_torch.parallel.sharding import LayerStack

Params = dict

_TARGET_DIMS = {
    "wq": ("hidden_size", "q_dim"),
    "wk": ("hidden_size", "kv_dim"),
    "wv": ("hidden_size", "kv_dim"),
    "wo": ("q_dim", "hidden_size"),
    "w_gate": ("hidden_size", "intermediate_size"),
    "w_up": ("hidden_size", "intermediate_size"),
    "w_down": ("intermediate_size", "hidden_size"),
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # which block weights get adapters; the default adapts every one
    targets: tuple[str, ...] = (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def __post_init__(self):
        unknown = set(self.targets) - set(_TARGET_DIMS)
        if unknown:
            raise ValueError(f"unknown LoRA targets {sorted(unknown)} "
                             f"(known: {sorted(_TARGET_DIMS)})")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def merge_lora(base: Params, adapters: Params,
               lora_cfg: LoraConfig) -> Params:
    """`base` with W <- W + (alpha / r) A @ B for every adapted block
    weight, summed in fp32 and cast back to W's dtype (the reference's
    arithmetic). Leaves other than the adapted weights are shared with
    `base`; the merged ones are new tensors on W's device."""
    blocks = dict(base["blocks"])

    def f32(x, device):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(device=device, dtype=torch.float32)

    for name, ab in adapters["blocks"].items():
        w = blocks[name]
        if any(isinstance(t, LayerStack) for t in (w, ab["A"], ab["B"])):
            # leaves of the trainer's mesh view: merged layer by layer,
            # where the block reads the layer (train/fsdp.py)
            blocks[name] = LayerStack.map(
                lambda w, a, b: (w.float() + lora_cfg.scaling
                                 * (a.float() @ b.float())).to(w.dtype),
                w, ab["A"], ab["B"])
            continue
        delta = torch.einsum("lir,lro->lio", f32(ab["A"], w.device),
                             f32(ab["B"], w.device))
        blocks[name] = (w.float() + lora_cfg.scaling * delta).to(w.dtype)
    out = dict(base)
    out["blocks"] = blocks
    return out


def init_lora(cfg, lora_cfg: LoraConfig, seed: int,
              device: torch.device | str) -> Params:
    """fp32 adapters from `seed` (a torch.Generator on `device`; the
    reference's recipe, not its values): A truncated normal on [-2, 2]
    times d_in**-0.5, B = 0, so the merged model starts exactly at the
    base."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, r = cfg.num_layers, lora_cfg.rank
    out: Params = {"blocks": {}}
    for name in lora_cfg.targets:
        d_in, d_out = (getattr(cfg, a) for a in _TARGET_DIMS[name])
        a = torch.empty((L, d_in, r), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(a, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out["blocks"][name] = {
            "A": a * d_in**-0.5,
            "B": torch.zeros((L, r, d_out), dtype=torch.float32,
                             device=device)}
    return out


def lora_logical_axes(base_axes: Params, lora_cfg: LoraConfig) -> Params:
    """Adapter logical axes mirroring the base weight's: A keeps the
    in-axis, B the out-axis; the rank axis replicates. `base_axes` is
    the model's `param_logical_axes` tree."""
    out: Params = {"blocks": {}}
    for name in lora_cfg.targets:
        layers_ax, in_ax, out_ax = base_axes["blocks"][name]
        out["blocks"][name] = {
            "A": (layers_ax, in_ax, "lora_rank"),
            "B": (layers_ax, "lora_rank", out_ax),
        }
    return out


def lora_train_tree(base: Params, adapters: Params) -> Params:
    return {"base": base, "lora": adapters}


def _label(tree: Params, label: str) -> Params:
    return {k: _label(v, label) if isinstance(v, dict) else label
            for k, v in tree.items()}


def lora_freeze_labels(tree: Params) -> Params:
    """The trainer's `freeze_labels` for a `lora_train_tree`: the base
    frozen (no gradient, no update, no optimizer state), the adapters
    trained."""
    return {"base": _label(tree["base"], "freeze"),
            "lora": _label(tree["lora"], "train")}


def _detach(tree: Params) -> Params:
    return {k: _detach(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def lora_loss_fn(model_loss_fn, lora_cfg: LoraConfig):
    """`loss(params, tokens, targets, mask)` over the model's params ->
    the same over the {"base", "lora"} train tree: the base detached
    (the reference's stop_gradient), merged with the adapters, then the
    model's loss."""

    def loss(tree: Params, tokens, targets, mask):
        merged = merge_lora(_detach(tree["base"]), tree["lora"], lora_cfg)
        return model_loss_fn(merged, tokens, targets, mask)

    return loss
