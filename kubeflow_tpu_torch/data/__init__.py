"""Data layer of the port (counterpart: kubeflow_tpu/data/): the BPE
tokenizer (with the native word encoder) and the KTSH token-shard
loaders (native, with a pure-Python loader giving the same batches)."""

from kubeflow_tpu_torch.data.bpe import Tokenizer, train as train_tokenizer
from kubeflow_tpu_torch.data.loader import (
    PyTokenLoader,
    TokenShardLoader,
    native_available,
    open_loader,
    write_shard,
)
