"""Models of the port (counterparts: kubeflow_tpu/models/)."""
