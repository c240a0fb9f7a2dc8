"""Weight bridge between the reference's parameter tree and the port's.

The reference (`kubeflow_tpu/models/{llama,gemma,llama_moe}.py::init`)
and the port lay parameters out the same way (stacked `[L, ...]` block
leaves under "blocks"; a Gemma tree has no `lm_head`, its head is the
tied embedding; a MoE tree has `router` [L, D, E] and the expert stacks
`w_gate` / `w_up` [L, E, D, M] and `w_down` [L, E, M, D]), so the
bridge only moves arrays and sets dtypes, by the serving storage rule
the three models share (`llama.leaf_dtype`: the router is a block
matrix). It takes the tree with every leaf already converted
to a numpy array (the caller does `jax.tree.map(np.asarray, params)`),
so this module needs no JAX. A quantized tree (the reference's
`quantize_blocks`) comes with each `QTensor` leaf flattened by the
caller to `{"q": int8, "scale": float32}` numpy arrays, and becomes the
port's `QTensor` (its bf16 scale widened to float32 and back is exact).
`pack_from_jax` carries a reference `AdapterPack` across.
`tensor_rank_params` cuts a full llama or gemma tree into one tensor
rank's serving params, by the mesh trainer's cut (train/fsdp.py).

A ViT tree (`ViTConfig`) and an MNIST MLP tree (`MLPConfig`, whose
`layers` is a list of `{"w", "b"}` dicts) keep every leaf in its
parameter dtype, fp32, as the reference keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import MATRICES, leaf_dtype
from kubeflow_tpu_torch.models.mnist import MLPConfig
from kubeflow_tpu_torch.models.vit import ViTConfig
from kubeflow_tpu_torch.serving.multilora import AdapterPack
from kubeflow_tpu_torch.serving.quant import QTensor


def from_jax(params: dict, cfg, device: torch.device | str,
             dtype: torch.dtype | None = None) -> dict:
    """numpy param tree -> torch params on `device`, for a LlamaConfig, a
    GemmaConfig or a MoELlamaConfig `cfg`. Block matrices go to `dtype`
    (default: cfg.dtype, the dtype the reference casts them to at every
    use), every other leaf to fp32. A `{"q", "scale"}` block leaf becomes a
    QTensor: q int8, scale bf16. For a ViTConfig or an MLPConfig every
    leaf goes to `dtype` (default: fp32, their parameter dtype)."""
    if isinstance(cfg, (ViTConfig, MLPConfig)):
        return _plain_tree(params, device, dtype or getattr(
            cfg, "param_dtype", torch.float32))

    def conv(name, arr):
        if isinstance(arr, dict):
            return QTensor(
                torch.from_numpy(np.array(arr["q"], np.int8)).to(device),
                torch.from_numpy(np.array(arr["scale"], np.float32)).to(
                    device=device, dtype=torch.bfloat16))
        want = leaf_dtype(cfg, name)
        if dtype is not None and name in MATRICES:
            want = dtype
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=want)

    out = {k: conv(k, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: conv(k, v) for k, v in params["blocks"].items()}
    return out


def tensor_rank_params(params: dict, cfg, index: int, size: int) -> dict:
    """Tensor rank `index` of `size`'s serving params from the full tree
    (`from_jax`'s, or a model's `init`): its query heads' columns of wq,
    its K/V heads' columns of wk / wv (or, where the axis is a multiple
    of the KV heads, the whole of them: `tensor.kv_columns` reads the one
    head rank i's query heads share, i // (size / n_kv)), its columns of
    w_gate / w_up, its rows of wo / w_down, its vocab block of the
    embedding and of lm_head; the norm scales whole. The cut is
    train/fsdp.py's (`tensor_rank_cut`), so serving and training cut
    alike. Refuses a config whose heads or vocab the axis does not
    divide, the MoE family and int8 `QTensor` leaves."""
    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.serving.engine import refuse_tensor_weights
    from kubeflow_tpu_torch.train.fsdp import tensor_rank_cut

    refuse_tensor_weights(params, cfg, size)
    mod = gemma if isinstance(cfg, gemma.GemmaConfig) else llama
    return tensor_rank_cut(params, mod.param_logical_axes(cfg), cfg, index,
                           size)


def _plain_tree(tree, device, dtype):
    """Every leaf of a nested dict / list tree to `dtype` on `device`."""
    if isinstance(tree, dict):
        return {k: _plain_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain_tree(v, device, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device=device,
                                                           dtype=dtype)


def pack_from_jax(pack, device: torch.device | str,
                  dtype: torch.dtype | None = None) -> AdapterPack:
    """A reference `AdapterPack` (its `blocks` arrays in the same
    layer-leading layout) as the port's, on `device`, each tensor in
    `dtype` (default: the array's own float width)."""

    def conv(arr):
        arr = np.asarray(arr)
        want = dtype or (torch.bfloat16 if arr.dtype.name == "bfloat16"
                         else torch.float32)
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=want)

    return AdapterPack(
        blocks={t: {"A": conv(ab["A"]), "B": conv(ab["B"])}
                for t, ab in pack.blocks.items()},
        scaling=float(pack.scaling), names=dict(pack.names))


def to_numpy(params):
    """torch param tree -> the same nested dict (and list) tree of fp32
    numpy arrays (the inverse of `from_jax`, for comparing trained params
    with the reference's)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_numpy(v) for v in params]
    return params.detach().float().cpu().numpy()
