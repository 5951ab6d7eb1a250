"""Stereo serving engine with temporal warm start (counterpart of
``repro.serving``; the LM engine is not ported yet)."""
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
from repro_torch.serving.warmstart import (  # noqa: F401
    WarmState,
    frame_thumbnail,
    prior_disagreement,
    scene_change_score,
)
