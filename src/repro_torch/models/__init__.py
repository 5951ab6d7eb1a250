"""LM model zoo (counterpart of ``repro.models``): the decoder of attention
layers (GQA, and deepseek-v2's multi-head latent attention with
static-capacity MoE); the other families wait (ROADMAP.md, queue 1)."""
from repro_torch.models.config import LayerKind, ModelConfig  # noqa: F401
from repro_torch.models.model import LMModel  # noqa: F401
