"""The data pipeline (JAX ``deepspeed_tpu/data/``): the resumable sampler,
the curriculum scheduler, the offline data analyzer, the memory-mapped
indexed dataset and random-LTD's token routing."""
from .curriculum_scheduler import CurriculumScheduler, truncate_to_seqlen  # noqa: F401
from .data_analyzer import (  # noqa: F401
    CurriculumDataSampler,
    CurriculumIndex,
    DataAnalyzer,
    curriculum_index_filter,
)
from .indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder  # noqa: F401
from .sampler import DeepSpeedDataSampler, find_fit_int_dtype  # noqa: F401
from .random_ltd import (  # noqa: F401
    RandomLTDScheduler,
    gather_tokens,
    random_ltd_layer,
    sample_kept_indices,
    scatter_tokens,
)
