"""Samplers: the lane-batched No-U-Turn Sampler (``mcmc/nuts.py``) that
draws the NUTS BPMF chains and lookahead lanes."""

from amf_tpu_torch.mcmc.nuts import (  # noqa: F401
    SAMPLER_ERA,
    GeneratorNoise,
    NUTSConfig,
    NUTSNoise,
    StepNoise,
    find_reasonable_step_size,
    nuts_kernel,
    run_nuts,
)
