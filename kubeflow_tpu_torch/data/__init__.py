"""Text data of the port (counterpart: kubeflow_tpu/data/): the BPE
tokenizer."""
