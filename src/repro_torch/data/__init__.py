"""The paper's workloads (Table 4) as synthetic generators (numpy only)."""
from repro_torch.data.datasets import DATASETS, make_dataset  # noqa: F401
