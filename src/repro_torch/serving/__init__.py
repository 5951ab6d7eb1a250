"""Stereo serving engine, cold path (counterpart of ``repro.serving``; the
LM engine and the warm start are not ported yet)."""
from repro_torch.serving.admission import AdmissionController  # noqa: F401
from repro_torch.serving.faults import (  # noqa: F401
    FaultInjected,
    FaultPlan,
    FaultSpec,
)
from repro_torch.serving.stereo_service import (  # noqa: F401
    CompletedFrame,
    FrameProgramCache,
    ServiceStats,
    StereoService,
)
