"""Models of the port (the counterparts of ``flexflow_tpu/models``)."""

from flexflow_torch.models.alexnet import build_alexnet
from flexflow_torch.models.candle_uno import CandleConfig, build_candle_uno
from flexflow_torch.models.cnn_catalog import (
    build_densenet121,
    build_inception_v3,
    build_resnet101,
    build_vgg16,
)
from flexflow_torch.models.dlrm import (
    DLRMConfig,
    build_dlrm,
    dlrm_random_benchmark_config,
    dlrm_strategy,
)

__all__ = [
    "build_alexnet",
    "build_vgg16",
    "build_inception_v3",
    "build_densenet121",
    "build_resnet101",
    "build_dlrm",
    "DLRMConfig",
    "dlrm_random_benchmark_config",
    "dlrm_strategy",
    "build_candle_uno",
    "CandleConfig",
]
