"""HPO layer (counterpart: kubeflow_tpu/hpo/): search spaces,
suggesters and local sweeps. The reference's Experiment controller is
control plane and stays out of the port."""

from kubeflow_tpu_torch.hpo.search import (
    Categorical,
    Double,
    GridSuggester,
    Integer,
    RandomSuggester,
    SearchSpace,
    TpeSuggester,
    better,
    make_suggester,
)
from kubeflow_tpu_torch.hpo.local import SweepResult, TrialResult, run_sweep
