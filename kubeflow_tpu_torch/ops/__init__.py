"""Plain tensor ops of the port (counterparts: kubeflow_tpu/ops/)."""
