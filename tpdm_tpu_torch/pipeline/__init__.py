"""Generation: the CFG denoiser, the adaptive sampler and the pipeline."""

from tpdm_tpu_torch.pipeline.pipeline import GenerationResult, TPDMPipeline
from tpdm_tpu_torch.pipeline.sampler import (
    SampleOutput,
    SamplerConfig,
    adaptive_sample,
    replay_logprobs,
)
