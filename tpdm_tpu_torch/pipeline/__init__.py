"""Generation: the CFG denoisers, the adaptive and fixed-schedule samplers
and the pipeline."""

from tpdm_tpu_torch.pipeline.pipeline import GenerationResult, TPDMPipeline
from tpdm_tpu_torch.pipeline.sampler import (
    FLOW_SOLVERS,
    CachedDenoise,
    SampleOutput,
    SamplerConfig,
    adaptive_sample,
    cache_reuse_schedule,
    fixed_schedule_sample,
    fixed_schedule_sample_autocached,
    fixed_schedule_sample_cached,
    fixed_schedule_sample_solver,
    replay_logprobs,
    solver_nfe,
)
