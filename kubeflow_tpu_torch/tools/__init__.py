"""Command-line tools of the port (counterparts: the repository's
`tools/`): `python -m kubeflow_tpu_torch.tools.prepare_data`,
`python -m kubeflow_tpu_torch.tools.eval_ppl` and
`python -m kubeflow_tpu_torch.tools.memplan`."""
