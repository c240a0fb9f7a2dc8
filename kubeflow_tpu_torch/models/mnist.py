"""MNIST MLP, the CPU smoke config (counterpart:
kubeflow_tpu/models/mnist.py).

Data: reads an `.npz` (keys: x_train/y_train/x_test/y_test) from
`KFTPU_MNIST_PATH` if set; otherwise generates the reference's
deterministic synthetic digit-blob dataset (the same numpy arrays for
the same seed). Parameters: `{"layers": [{"w", "b"}, ...], "out_w",
"out_b"}`, `w` as [in, out], all fp32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterator

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    input_dim: int = 784
    hidden_dims: tuple[int, ...] = (512, 512)
    num_classes: int = 10


MNIST_MLP = MLPConfig()


def param_logical_axes(cfg: MLPConfig = MNIST_MLP) -> Params:
    """Logical axis names per param leaf (the reference's tree)."""
    return {
        "layers": [{"w": ("embed", "mlp"), "b": ("mlp",)}
                   for _ in cfg.hidden_dims],
        "out_w": ("embed", "vocab"),
        "out_b": ("vocab",),
    }


def init(seed: int | torch.Generator = 0, cfg: MLPConfig = MNIST_MLP,
         device: torch.device | str | None = None) -> Params:
    """Random params: normal weights scaled by fan_in^-0.5, zero biases,
    drawn on the CPU from `seed` (an int or a `torch.Generator`), then
    moved to `device` (default: the card), so every device gets the
    same values."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    dims = (cfg.input_dim, *cfg.hidden_dims)

    def normal(d_in, d_out):
        return (torch.randn(d_in, d_out, generator=gen)
                * d_in ** -0.5).to(dev)

    layers = [{"w": normal(d_in, d_out), "b": torch.zeros(d_out,
                                                          device=dev)}
              for d_in, d_out in zip(dims[:-1], dims[1:])]
    return {"layers": layers,
            "out_w": normal(dims[-1], cfg.num_classes),
            "out_b": torch.zeros(cfg.num_classes, device=dev)}


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[b, 784] -> logits [b, 10]."""
    h = x
    for layer in params["layers"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ params["out_w"] + params["out_b"]


def loss_and_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy (logsumexp minus the gold logit) and accuracy."""
    logits = apply(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


def load_dataset(n_train: int = 4096, n_test: int = 512, seed: int = 0):
    """(x_train, y_train, x_test, y_test) float32 [N,784] / int32 [N]."""
    path = os.environ.get("KFTPU_MNIST_PATH", "")
    if path and os.path.exists(path):
        d = np.load(path)
        return (
            d["x_train"].reshape(len(d["x_train"]), -1).astype(np.float32)
            / 255.0,
            d["y_train"].astype(np.int32),
            d["x_test"].reshape(len(d["x_test"]), -1).astype(np.float32)
            / 255.0,
            d["y_test"].astype(np.int32),
        )
    # Synthetic stand-in: 10 gaussian class prototypes + noise. Linearly
    # separable enough that a learning bug shows as low accuracy.
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 784)).astype(np.float32)

    def gen(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = protos[y] + rng.normal(scale=2.0, size=(n, 784)).astype(
            np.float32)
        return x, y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    return x_tr, y_tr, x_te, y_te


def batches(x: np.ndarray, y: np.ndarray, batch_size: int,
            seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    if batch_size > len(x):
        raise ValueError(
            f"batch_size {batch_size} exceeds dataset size {len(x)}")
    idx = np.random.default_rng(seed).permutation(len(x))
    for i in range(0, len(x) - batch_size + 1, batch_size):
        j = idx[i:i + batch_size]
        yield x[j], y[j]


def sgd_step(params: Params, x: torch.Tensor, y: torch.Tensor,
             lr: float) -> torch.Tensor:
    """One plain SGD step in place (p -= lr * grad); returns the loss."""
    leaves = [*(t for layer in params["layers"] for t in layer.values()),
              params["out_w"], params["out_b"]]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_and_accuracy(params, x, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            t.sub_(lr * g)
    return loss.detach()


def batch_stream(x: np.ndarray, y: np.ndarray, batch_size: int,
                 device: torch.device) -> Iterator[tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """`batches` over the epochs (seed = epoch), moved to `device`: the
    reference's smoke and bench loops."""
    epoch = 0
    while True:
        for xb, yb in batches(x, y, batch_size, seed=epoch):
            yield (torch.from_numpy(xb).to(device),
                   torch.from_numpy(yb).to(device))
        epoch += 1


def train_smoke(steps: int = 100, batch_size: int = 128, lr: float = 0.1,
                device: torch.device | str | None = None
                ) -> dict[str, float]:
    """The end-to-end smoke: SGD for `steps` on `device` (default: the
    card), returns the reference's metrics."""
    dev = resolve_device(device)
    x_tr, y_tr, x_te, y_te = load_dataset()
    params = init(0, device=dev)
    stream = batch_stream(x_tr, y_tr, batch_size, dev)
    for _ in range(steps):
        loss = sgd_step(params, *next(stream), lr)
    with torch.no_grad():
        test_loss, test_acc = loss_and_accuracy(
            params, torch.from_numpy(x_te).to(dev),
            torch.from_numpy(y_te).to(dev))
    return {
        "final_train_loss": float(loss),
        "test_loss": float(test_loss),
        "test_accuracy": float(test_acc),
    }
