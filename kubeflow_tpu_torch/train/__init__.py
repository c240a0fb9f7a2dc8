"""Single-device training (counterpart: kubeflow_tpu/train/): the
model-agnostic `Trainer` over llama's, gemma's or the MoE family's
loss, with AdamW or Adafactor and frozen subtrees; LoRA training in
train/lora.py; checkpoints in train/checkpoint.py."""

from kubeflow_tpu_torch.train.lora import (
    LoraConfig,
    init_lora,
    lora_freeze_labels,
    lora_loss_fn,
    lora_train_tree,
    merge_lora,
)
from kubeflow_tpu_torch.train.trainer import (
    Adafactor,
    AdamW,
    TrainConfig,
    Trainer,
    TrainState,
    chunked_cross_entropy_from_hidden,
    cross_entropy_loss,
    estimate_step_flops,
    make_optimizer,
)

__all__ = ["Adafactor", "AdamW", "LoraConfig", "TrainConfig", "Trainer",
           "TrainState", "chunked_cross_entropy_from_hidden",
           "cross_entropy_loss", "estimate_step_flops", "init_lora",
           "lora_freeze_labels", "lora_loss_fn", "lora_train_tree",
           "make_optimizer", "merge_lora"]
