from .checkpoint import Checkpointer
from .compression import (compression_ratio, init_error_state,
                          make_int8_compressor)
from .elastic import ElasticConfig, ElasticTrainer, SimulatedFailure
from .optimizer import AdamWConfig, apply_updates, init_state, make_train_step

__all__ = [
    "AdamWConfig", "init_state", "apply_updates", "make_train_step",
    "Checkpointer", "make_int8_compressor", "init_error_state",
    "compression_ratio", "ElasticTrainer", "ElasticConfig", "SimulatedFailure",
]
