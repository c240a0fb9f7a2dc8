"""Models of the port (counterparts: kubeflow_tpu/models/): llama,
gemma, the MoE llama family, ViT and the MNIST MLP."""
