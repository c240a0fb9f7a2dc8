"""Single-device training (counterpart: kubeflow_tpu/train/): the
model-agnostic `Trainer` over llama's or gemma's `apply`; checkpoints
in train/checkpoint.py."""

from kubeflow_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainState,
    chunked_cross_entropy_from_hidden,
    cross_entropy_loss,
    estimate_step_flops,
    make_optimizer,
)

__all__ = ["TrainConfig", "Trainer", "TrainState",
           "chunked_cross_entropy_from_hidden", "cross_entropy_loss",
           "estimate_step_flops", "make_optimizer"]
