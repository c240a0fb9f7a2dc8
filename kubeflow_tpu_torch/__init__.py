"""PyTorch/CUDA port of `kubeflow_tpu`'s serving path for NVIDIA Hopper.

The JAX package (`kubeflow_tpu`) is the reference; every module here
mirrors the name of its counterpart there, and the tests hold each one
against it on the same inputs. This package imports `torch`, never
`jax`, and nothing of `kubeflow_tpu`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"` (the CPU tests do); see `device.py`. The two Pallas
kernels of the serving path are hand-written CUDA C++ for `sm_90a`
under `csrc/`, built with `nvcc` at first use (`ops/cuda/_build.py`).
"""
