"""LM model zoo (counterpart of ``repro.models``): the dense GQA decoder;
the other families wait (ROADMAP.md, queue 1)."""
from repro_torch.models.config import LayerKind, ModelConfig  # noqa: F401
from repro_torch.models.model import LMModel  # noqa: F401
