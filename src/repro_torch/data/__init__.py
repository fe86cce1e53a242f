from .synthetic import DATASETS, DatasetSpec, make_stream, dataset_service  # noqa: F401
from .near_tie import dot_cosine_disagree, near_tie_trace  # noqa: F401
