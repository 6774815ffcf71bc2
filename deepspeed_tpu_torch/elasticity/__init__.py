"""Elasticity: batch-size math for restart-at-any-scale and the elastic
agent (reference deepspeed/elasticity/) — counterpart of
``deepspeed_tpu/elasticity``."""
from .elastic_agent import ElasticAgent  # noqa: F401
from .elasticity import (  # noqa: F401
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
    elasticity_enabled,
    ensure_immutable_elastic_config,
)
