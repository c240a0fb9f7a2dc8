"""Command-line tools of the port (counterparts: the repository's
`tools/`): `python -m kubeflow_tpu_torch.tools.prepare_data` and
`python -m kubeflow_tpu_torch.tools.eval_ppl`."""
