"""Batched greedy generation and the micro-batching server."""

from paddle_tpu_torch.inference.generate import GenerationConfig, Generator
from paddle_tpu_torch.inference.serving import (BatchingGeneratorServer,
                                                RequestExpired)

__all__ = ["BatchingGeneratorServer", "GenerationConfig", "Generator",
           "RequestExpired"]
