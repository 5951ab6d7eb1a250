"""LM model zoo (counterpart of ``repro.models``): one decoder of GQA, MLA,
Mamba and xLSTM layers, with dense MLPs or static-capacity MoE, for every
architecture of the reference."""
from repro_torch.models.config import LayerKind, ModelConfig  # noqa: F401
from repro_torch.models.model import LMModel  # noqa: F401
