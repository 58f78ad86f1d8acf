"""Configuration dataclasses, shared with the JAX package.

`facialmmt_tpu.config` is pure dataclasses and imports no JAX at module level
(its `resolve_prng_impl` does, lazily, and is not re-exported here).
"""

from facialmmt_tpu.config import (CrossModalConfig, DataConfig,  # noqa: F401
                                  EncoderConfig, FacialMMTConfig,
                                  OptimConfig, ParallelConfig, RuntimeConfig,
                                  SwinConfig, TextEncoderConfig,
                                  resolve_text_config)
