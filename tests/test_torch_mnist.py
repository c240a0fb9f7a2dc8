"""The port's MNIST MLP (kubeflow_tpu_torch/models/mnist.py) against the
reference's (kubeflow_tpu/models/mnist.py) on the CPU: the same dataset
arrays for the same seed (and from KFTPU_MNIST_PATH), the same batches,
and with the reference's weights carried over by `bridge.from_jax` the
same logits, loss, accuracy and gradients (fp32: logits and loss 1e-5,
each gradient leaf 1e-5 of its largest element plus 1e-4 relative).
The port's smoke reaches the reference's 0.90 accuracy gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import mnist as jmnist
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import mnist


@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_matches_reference(seed):
    got = mnist.load_dataset(n_train=256, n_test=64, seed=seed)
    want = jmnist.load_dataset(n_train=256, n_test=64, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_dataset_from_file(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.integers(0, 256, (20, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, 20), x_test=rng.integers(
                 0, 256, (5, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, 5))
    monkeypatch.setenv("KFTPU_MNIST_PATH", str(path))
    for g, w in zip(mnist.load_dataset(), jmnist.load_dataset()):
        np.testing.assert_array_equal(g, w)
    assert mnist.load_dataset()[0].shape == (20, 784)


def test_batches_match_reference():
    x, y, _, _ = mnist.load_dataset(n_train=300, n_test=10)
    got = list(mnist.batches(x, y, 64, seed=2))
    want = list(jmnist.batches(x, y, 64, seed=2))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="exceeds"):
        next(mnist.batches(x, y, 301))


def test_init_law_and_shapes():
    p = mnist.init(0, device="cpu")
    want = jax.tree.map(np.shape, jmnist.init(jax.random.key(0)))
    assert [tuple(layer["w"].shape) for layer in p["layers"]] == \
        [tuple(layer["w"]) for layer in want["layers"]]
    assert tuple(p["out_w"].shape) == tuple(want["out_w"])
    # fan_in^-0.5 scaled normals, zero biases
    assert abs(float(p["layers"][0]["w"].std()) - 784 ** -0.5) < 2e-3
    assert float(p["layers"][1]["b"].abs().sum()) == 0.0
    g = torch.Generator().manual_seed(0)
    again = mnist.init(g, device="cpu")
    torch.testing.assert_close(again["out_w"], p["out_w"], rtol=0, atol=0)


def test_loss_accuracy_and_gradients_match_reference():
    ref = jax.tree.map(np.asarray, jmnist.init(jax.random.key(1)))
    x, y, _, _ = mnist.load_dataset(n_train=128, n_test=1)
    (want_loss, want_acc), want_g = jax.value_and_grad(
        jmnist.loss_and_accuracy, has_aux=True)(ref, jnp.asarray(x),
                                                jnp.asarray(y))
    params = bridge.from_jax(ref, mnist.MNIST_MLP, "cpu")
    assert isinstance(params["layers"], list)
    leaves = [*(layer[k] for layer in params["layers"] for k in ("w", "b")),
              params["out_w"], params["out_b"]]
    for t in leaves:
        t.requires_grad_(True)
    loss, acc = mnist.loss_and_accuracy(params, torch.from_numpy(x),
                                        torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-5, rtol=1e-5)
    assert float(acc) == float(want_acc)
    np.testing.assert_allclose(
        mnist.apply(params, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmnist.apply(ref, jnp.asarray(x))), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    wg = jax.tree.map(np.asarray, want_g)
    want = [*(layer[k] for layer in wg["layers"] for k in ("w", "b")),
            wg["out_w"], wg["out_b"]]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
    back = bridge.to_numpy(params)
    np.testing.assert_array_equal(back["layers"][1]["w"],
                                  ref["layers"][1]["w"])


def test_sgd_step_is_plain_sgd():
    params = mnist.init(0, device="cpu")
    before = params["out_b"].clone()
    x, y, _, _ = mnist.load_dataset(n_train=64, n_test=1)
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    leaves = [params["out_b"]]
    params["out_b"].requires_grad_(True)
    loss, _ = mnist.loss_and_accuracy(params, xb, yb)
    (g,) = torch.autograd.grad(loss, leaves)
    got = mnist.sgd_step(params, xb, yb, 0.1)
    torch.testing.assert_close(got, loss.detach())
    torch.testing.assert_close(params["out_b"].detach(), before - 0.1 * g)


def test_train_smoke_reaches_the_gate():
    out = mnist.train_smoke(device="cpu")
    assert set(out) == {"final_train_loss", "test_loss", "test_accuracy"}
    assert out["test_accuracy"] >= 0.90, out
    assert out["final_train_loss"] < 1.0
