from .synthetic import DATASETS, DatasetSpec, make_stream, dataset_service  # noqa: F401
