"""Weight-only int8 quantization for serving (counterpart:
kubeflow_tpu/serving/quant.py).

Decode reads every block weight once per step, so its bytes are its
time; symmetric per-output-channel int8 halves the bf16 bytes of the
seven block matrices at ~0.3% RMS weight error. Embed, lm_head, the
norms and the MoE router stay in their source dtype. The MoE family's
expert stacks are QTensors too, dequantized whole each step by its
serving FFN (`QTensor.to`, the reference's `.astype`): no expert
product reads int8 yet.

`QTensor` holds `q` int8 `[..., in, out]` and `scale` bf16 `[..., 1,
out]`; indexing a stacked `[L, in, out]` leaf gives layer l's
`[in, out]` QTensor of views, as the engine's per-layer views of plain
leaves are. `qdot` is every block matmul of the serving paths:

- a plain tensor gives `h @ w.to(dtype)`, the bf16 paths' product;
- a QTensor gives `(h @ q) * scale`, the reference's right-hand form,
  which keeps the weight int8 up to the product: on a CUDA tensor
  through the hand-written `int8_proj` kernel (ops/cuda/int8_proj.py),
  because PyTorch, unlike XLA, fuses no int8 -> bf16 convert into a
  product's operand read; on the CPU through its plain version.

`qdot_many` is the products of one h by several weights (a layer's wq,
wk, wv; its w_gate, w_up): QTensors in one `int8_proj_many` launch, each
product bit-identical to its `qdot`.

`quantize` repeats the reference's arithmetic step for step (the scale
rounded to its storage dtype first, then round-half-to-even of w / scale
clipped to +-127), so on the same fp32 weights `q` and `scale` are
bit-equal to the reference's. Serving only: quantize loaded weights,
never training masters.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.cuda.int8_proj import int8_proj, int8_proj_many

Params = dict

BLOCK_MATMUL_WEIGHTS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class QTensor:
    """int8 weights + per-output-channel scales, dequantized on read.

    q is the original weight shape [..., in, out]; scale is [..., 1, out]
    (the contraction axis reduced, kept), so dequantization is a
    broadcast multiply over any stacked leading axes."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """The dequantized weight in `dtype`: q * scale."""
        return self.q.to(dtype) * self.scale.to(dtype)

    def __getitem__(self, idx) -> "QTensor":
        """A leading-axis slice (layer l of a stacked leaf): views of q
        and scale."""
        return QTensor(self.q[idx], self.scale[idx])

    def unbind(self, dim: int = 0) -> tuple:
        """Layer views of a stacked leaf, as `Tensor.unbind(0)` gives
        them (the models' forwards unbind every block leaf once)."""
        if dim != 0:
            raise ValueError("a QTensor unbinds along its leading axis only")
        return tuple(self[i] for i in range(self.q.shape[0]))

    def __repr__(self) -> str:
        return (f"QTensor(q={tuple(self.q.shape)} {self.q.dtype}, "
                f"scale={tuple(self.scale.shape)})")


def qdot(h: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """`h @ w` in `dtype`, a QTensor's weights int8 up to the product:
    `(h @ q) * scale` is exactly `h @ (q * scale)` because the scale is
    constant along the contraction axis."""
    if isinstance(w, QTensor):
        return int8_proj(h.to(dtype), w.q, w.scale)
    return h @ w.to(dtype)


def qdot_many(h: torch.Tensor, ws, dtype: torch.dtype) -> list:
    """[qdot(h, w, dtype) for w in ws], bit for bit: when every weight is
    a QTensor, one `int8_proj_many` launch (at most three weights);
    otherwise each product as `qdot` makes it."""
    if ws and all(isinstance(w, QTensor) for w in ws):
        return int8_proj_many(h.to(dtype), [(w.q, w.scale) for w in ws])
    return [qdot(h, w, dtype) for w in ws]


def quantize(w: torch.Tensor, *,
             scale_dtype: torch.dtype = torch.bfloat16) -> QTensor:
    """Symmetric per-output-channel int8 over the contraction axis -2.
    The scale is rounded to its storage dtype BEFORE quantizing:
    dequantization multiplies by the stored scale."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = (torch.clamp(amax, min=1e-30) / 127.0).to(scale_dtype)
    q = torch.clamp(torch.round(w32 / scale.to(torch.float32)),
                    -127, 127).to(torch.int8)
    return QTensor(q, scale)


def _quantize_stacked(w: torch.Tensor) -> QTensor:
    """`quantize` of a stacked [L, ..., in, out] leaf one layer at a
    time into preallocated q and scale, so the fp32 transient is one
    layer (a whole-leaf quantize of an 8B model's w_gate would hold a
    second fp32 copy of it)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]),
                        dtype=torch.bfloat16, device=w.device)
    for li in range(w.shape[0]):
        one = quantize(w[li])
        q[li].copy_(one.q)
        scale[li].copy_(one.scale)
    return QTensor(q, scale)


def quantize_blocks(params: Params) -> Params:
    """Serving params with the seven block matmul weights as QTensors
    (layer by layer); every other leaf passes through untouched (the
    same objects). A MoE tree's expert stacks [L, E, D, M] quantize per
    expert and output channel over D, as the reference's; its router
    stays as it is."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in BLOCK_MATMUL_WEIGHTS:
        w = blocks[name]
        blocks[name] = (_quantize_stacked(w) if w.ndim >= 3
                        else quantize(w))
    out["blocks"] = blocks
    return out


def param_bytes(params) -> int:
    """Bytes a decode step reads for weights (QTensor-aware)."""
    if isinstance(params, QTensor):
        return params.nbytes
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
